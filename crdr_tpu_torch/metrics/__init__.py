from .lpips import AlexNetFeatures, LPIPSAlex, init_lpips, load_lpips_params
