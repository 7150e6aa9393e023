"""Serving: the micro-batcher and its HTTP front end (counterpart of
``crdr_tpu/serving/``)."""

from .batcher import MicroBatcher  # noqa: F401
