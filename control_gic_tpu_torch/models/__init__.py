from .blocks import AttnBlock, Downsample, ResnetBlock, SpatialNorm, Upsample
from .cgic import CGIC, CGICConfig, EncodeOutput
from .decoder import Decoder
from .encoder import Encoder
