from .bitmap import BitmapCodec
from .huffman import HuffmanCodec, build_huffman_codes
from .huffman_device import (encode_on_device, huffman_pack_bits, pack_tables,
                             supports_table)
from .stream_pack import compact_masked, pack_streams_batch, streams_to_bytes
