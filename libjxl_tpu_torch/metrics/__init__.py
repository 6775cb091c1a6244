from .distance import compute_psnr, butteraugli_distance, msssim_xyb
from .ssimulacra2 import ssimulacra2
