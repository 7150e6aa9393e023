from .bottleneck import (EntropyBottleneck, EntropyBottleneckCodec,
                         SteEntropyBottleneck)
from .gaussian import (GaussianConditionalCodec, GaussianMeanScaleConditional,
                       GaussianScaleConditional,
                       SteGaussianMeanScaleConditional, build_indexes,
                       gaussian_likelihood, get_scale_table)
from .ops import (UniformNoise, lower_bound, standardized_cumulative,
                  ste_round)
