"""Multi-device paths (port of control_gic_tpu/parallel/): device meshes
(`mesh`), the process group of data-parallel training (`multihost`), the
high-res tiled codec with its tile mesh (`tiling`), and the H-sharded
single-pass codec (`halo`, `spatial_encoder`, `spatial_decoder`,
`spatial_codec`)."""
from .mesh import make_mesh, data_sharding, replicated_sharding, shard_batch
from .tiling import compress_tiled, compute_padding, tile_grid
from .halo import halo_exchange, halo_conv2d, sharded_conv2d_same
from .spatial_decoder import decode_spatial_sharded
