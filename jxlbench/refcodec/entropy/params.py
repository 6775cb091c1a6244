"""Entropy-coding constants (reference: lib/jxl/ans_params.h)."""

ANS_LOG_TAB_SIZE = 12
ANS_TAB_SIZE = 1 << ANS_LOG_TAB_SIZE
ANS_TAB_MASK = ANS_TAB_SIZE - 1
ANS_SIGNATURE = 0x13  # initial/final rANS state high byte (CRC-like)
ANS_MAX_ALPHABET_SIZE = 256
PREFIX_MAX_BITS = 15
PREFIX_MAX_ALPHABET_SIZE = 4096
# Histogram clustering cap (enc_ans_params.h kClustersLimit)
CLUSTERS_LIMIT = 128
# LZ77 decode window (dec_ans.h:119)
LZ77_WINDOW_SIZE = 1 << 20
