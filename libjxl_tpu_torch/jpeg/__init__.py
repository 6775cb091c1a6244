from .data import JPEGData, parse_jpeg
from .writer import write_jpeg
from .pixels import jpeg_to_pixels
