from .conv import Conv2d, ConvTranspose2d, Dense
from .fourier import fourier_embed
from .interp_ca import InterpChAtt
from .layers import (BaseBlock, BetaCondBaseBlock, BetaCondResidualBottleneckBlocks,
                     ChengNLAM, NLAMResBlock, ResidualBottleneckBlocks, up_conv)
from .norm import (GDN, BatchNorm2D, ChannelNorm2D, InstanceNorm2D,
                   NonNegativeParam, make_norm)
