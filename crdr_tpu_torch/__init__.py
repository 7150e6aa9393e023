"""crdr_tpu_torch — the PyTorch / CUDA port of crdr_tpu for NVIDIA Hopper.

Same layout and names as the JAX package beside it (``crdr_tpu``), which
stays the reference the port is held against; the port imports nothing of
it.  Entry points: ``crdr_tpu_torch.models.build_comp_model(opt, device)``
then ``codec_setup()``, ``compress*`` and ``decompress*``; ``run_model`` and
``validation``; the CLI ``python -m crdr_tpu_torch.cli.compress``; the
trainers (stages 1-3) ``crdr_tpu_torch.trainer.build_trainer(opt, device)``
and ``python -m crdr_tpu_torch.cli.train``.
"""
