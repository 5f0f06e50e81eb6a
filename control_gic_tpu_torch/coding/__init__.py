from .bitmap import BitmapCodec
from .huffman import HuffmanCodec, build_huffman_codes
