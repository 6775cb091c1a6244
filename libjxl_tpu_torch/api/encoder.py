"""Options-based encoder API (the JxlEncoder / JxlEncoderFrameSettings
surface, lib/include/jxl/encode.h:126-399,415-1593).

The reference exposes 40 integer/float frame-setting knobs set through
``JxlEncoderFrameSettingsSetOption`` plus expert gating
(``JxlEncoderAllowExpertOptions``, encode.h:1543). This module mirrors
that protocol: every setting id exists and is range-validated like
encode.cc's switch; the ones that map onto this framework's encoder are
wired through to :func:`api.codestream.encode_lossy` /
:func:`encode_lossless`, the rest are accepted (so option-setting code
written against libjxl runs unchanged) and ignored with a debug log,
exactly like the reference ignores settings outside their active tiers.

Usage::

    enc = Encoder()
    fs = enc.frame_settings()
    fs.set_option(SETTING_EFFORT, 7)
    fs.set_distance(1.0)
    enc.add_image_frame(fs, pixels)        # (H, W, 3|4) uint8
    data = enc.process_output()

Device: ``Encoder(device=...)`` is where the lossy encodes' device stages
run, passed to encode_lossy / encode_animation: "cuda" by default (a
missing card raises where a stage needs it), "cpu" the torch forms with
the kernels' plain twins, None the host encode. Lossless frames and JPEG
recompression run on the host.
"""

from __future__ import annotations

import logging

import numpy as np

from ..base.status import JXLError

log = logging.getLogger("libjxl_tpu_torch.encoder")

# JxlEncoderFrameSettingId (encode.h:126-399)
SETTING_EFFORT = "effort"
SETTING_DECODING_SPEED = "decoding_speed"
SETTING_RESAMPLING = "resampling"
SETTING_EXTRA_CHANNEL_RESAMPLING = "extra_channel_resampling"
SETTING_ALREADY_DOWNSAMPLED = "already_downsampled"
SETTING_PHOTON_NOISE = "photon_noise"
SETTING_NOISE = "noise"
SETTING_DOTS = "dots"
SETTING_PATCHES = "patches"
SETTING_EPF = "epf"
SETTING_GABORISH = "gaborish"
SETTING_MODULAR = "modular"
SETTING_KEEP_INVISIBLE = "keep_invisible"
SETTING_GROUP_ORDER = "group_order"
SETTING_GROUP_ORDER_CENTER_X = "group_order_center_x"
SETTING_GROUP_ORDER_CENTER_Y = "group_order_center_y"
SETTING_RESPONSIVE = "responsive"
SETTING_PROGRESSIVE_AC = "progressive_ac"
SETTING_QPROGRESSIVE_AC = "qprogressive_ac"
SETTING_PROGRESSIVE_DC = "progressive_dc"
SETTING_CHANNEL_COLORS_GLOBAL_PERCENT = "channel_colors_global_percent"
SETTING_CHANNEL_COLORS_GROUP_PERCENT = "channel_colors_group_percent"
SETTING_PALETTE_COLORS = "palette_colors"
SETTING_LOSSY_PALETTE = "lossy_palette"
SETTING_COLOR_TRANSFORM = "color_transform"
SETTING_MODULAR_COLOR_SPACE = "modular_color_space"
SETTING_MODULAR_GROUP_SIZE = "modular_group_size"
SETTING_MODULAR_PREDICTOR = "modular_predictor"
SETTING_MODULAR_MA_TREE_LEARNING_PERCENT = \
    "modular_ma_tree_learning_percent"
SETTING_MODULAR_NB_PREV_CHANNELS = "modular_nb_prev_channels"
SETTING_JPEG_RECON_CFL = "jpeg_recon_cfl"
SETTING_INDEX_BOX = "index_box"
SETTING_BROTLI_EFFORT = "brotli_effort"
SETTING_JPEG_COMPRESS_BOXES = "jpeg_compress_boxes"
SETTING_JPEG_KEEP_EXIF = "jpeg_keep_exif"
SETTING_JPEG_KEEP_XMP = "jpeg_keep_xmp"
SETTING_JPEG_KEEP_JUMBF = "jpeg_keep_jumbf"
SETTING_USE_FULL_IMAGE_HEURISTICS = "use_full_image_heuristics"
SETTING_DISABLE_PERCEPTUAL_HEURISTICS = "disable_perceptual_heuristics"
SETTING_BUFFERING = "buffering"

# (lo, hi) inclusive valid ranges, -1 = "default" accepted everywhere
# (encode.cc's JxlEncoderFrameSettingsSetOption validation)
_RANGES = {
    SETTING_EFFORT: (1, 10),
    SETTING_DECODING_SPEED: (0, 4),
    SETTING_RESAMPLING: (-1, 8),
    SETTING_EXTRA_CHANNEL_RESAMPLING: (-1, 8),
    SETTING_ALREADY_DOWNSAMPLED: (0, 1),
    SETTING_NOISE: (-1, 1),
    SETTING_DOTS: (-1, 1),
    SETTING_PATCHES: (-1, 1),
    SETTING_EPF: (-1, 3),
    SETTING_GABORISH: (-1, 1),
    SETTING_MODULAR: (-1, 1),
    SETTING_KEEP_INVISIBLE: (-1, 1),
    SETTING_GROUP_ORDER: (-1, 1),
    SETTING_GROUP_ORDER_CENTER_X: (-1, 1 << 30),
    SETTING_GROUP_ORDER_CENTER_Y: (-1, 1 << 30),
    SETTING_RESPONSIVE: (-1, 1),
    SETTING_PROGRESSIVE_AC: (-1, 1),
    SETTING_QPROGRESSIVE_AC: (-1, 1),
    SETTING_PROGRESSIVE_DC: (-1, 2),
    SETTING_CHANNEL_COLORS_GLOBAL_PERCENT: (-1, 100),
    SETTING_CHANNEL_COLORS_GROUP_PERCENT: (-1, 100),
    SETTING_PALETTE_COLORS: (-1, 1 << 16),
    SETTING_LOSSY_PALETTE: (-1, 1),
    SETTING_COLOR_TRANSFORM: (-1, 2),
    SETTING_MODULAR_COLOR_SPACE: (-1, 41),
    SETTING_MODULAR_GROUP_SIZE: (-1, 3),
    SETTING_MODULAR_PREDICTOR: (-1, 15),
    SETTING_MODULAR_MA_TREE_LEARNING_PERCENT: (-1, 100),
    SETTING_MODULAR_NB_PREV_CHANNELS: (-1, 11),
    SETTING_JPEG_RECON_CFL: (-1, 1),
    SETTING_INDEX_BOX: (0, 1),
    SETTING_BROTLI_EFFORT: (-1, 11),
    SETTING_JPEG_COMPRESS_BOXES: (-1, 1),
    SETTING_JPEG_KEEP_EXIF: (-1, 1),
    SETTING_JPEG_KEEP_XMP: (-1, 1),
    SETTING_JPEG_KEEP_JUMBF: (-1, 1),
    SETTING_USE_FULL_IMAGE_HEURISTICS: (-1, 1),
    SETTING_DISABLE_PERCEPTUAL_HEURISTICS: (0, 1),
    SETTING_BUFFERING: (-1, 3),
}

# settings actually wired into this framework's encoder; the rest are
# accepted + logged (reference parity for out-of-tier settings)
_WIRED = {
    SETTING_EFFORT, SETTING_RESAMPLING, SETTING_PHOTON_NOISE,
    SETTING_NOISE, SETTING_DOTS, SETTING_PATCHES, SETTING_EPF,
    SETTING_GABORISH, SETTING_MODULAR, SETTING_RESPONSIVE,
    SETTING_PROGRESSIVE_AC, SETTING_MODULAR_GROUP_SIZE,
    SETTING_JPEG_COMPRESS_BOXES, SETTING_BUFFERING,
}


class FrameSettings:
    """JxlEncoderFrameSettings analog: a bag of validated options."""

    def __init__(self, encoder: "Encoder"):
        self._enc = encoder
        self.options = {}
        self.distance = 1.0
        self.lossless = False

    def set_option(self, setting: str, value) -> None:
        """JxlEncoderFrameSettingsSetOption (encode.h:1287)."""
        if setting == SETTING_PHOTON_NOISE:
            # float-valued (JxlEncoderSetFrameSettingsFloatOption)
            if value < 0:
                raise JXLError("photon_noise ISO must be >= 0")
            self.options[setting] = float(value)
            return
        if setting not in _RANGES:
            raise JXLError(f"unknown frame setting {setting!r}")
        lo, hi = _RANGES[setting]
        iv = int(value)
        if not (lo <= iv <= hi):
            raise JXLError(
                f"value {iv} out of range [{lo}, {hi}] for {setting!r}")
        if setting == SETTING_EFFORT and iv == 10 \
                and not self._enc.expert_options_allowed:
            # e10 is expert-gated (encode.h:1543)
            raise JXLError("effort 10 requires allow_expert_options()")
        if setting not in _WIRED and iv not in (-1,):
            log.debug("frame setting %s=%s accepted but not active in "
                      "this encoder", setting, iv)
        self.options[setting] = iv

    def set_distance(self, distance: float) -> None:
        """JxlEncoderSetFrameDistance (encode.h:1310): [0, 25]."""
        if not (0.0 <= distance <= 25.0):
            raise JXLError("distance must be in [0, 25]")
        # d=0 selects lossless, any later d>0 deselects it — the flag
        # must not latch (the reference keeps SetFrameDistance and
        # SetFrameLossless independent; set_lossless still overrides)
        self.distance = float(distance)
        self.lossless = distance == 0.0

    def set_lossless(self, lossless: bool) -> None:
        self.lossless = bool(lossless)


class Encoder:
    """JxlEncoder analog: queue frames, produce the output bytes."""

    def __init__(self, device="cuda"):
        self.device = device
        self.expert_options_allowed = False
        self.use_container = False
        self.use_boxes = False
        self._frames = []  # (FrameSettings, kind, payload)
        self._output = None

    def allow_expert_options(self) -> None:
        """JxlEncoderAllowExpertOptions (encode.h:1543)."""
        self.expert_options_allowed = True

    def frame_settings(self) -> FrameSettings:
        """JxlEncoderFrameSettingsCreate (encode.h:1270)."""
        return FrameSettings(self)

    def add_image_frame(self, settings: FrameSettings,
                        pixels: np.ndarray) -> None:
        """JxlEncoderAddImageFrame (encode.h:2412 impl)."""
        if self._output is not None:
            raise JXLError("encoder output already produced")
        self._frames.append((settings, "image", np.asarray(pixels)))

    def add_jpeg_frame(self, settings: FrameSettings,
                       jpeg_bytes: bytes) -> None:
        """JxlEncoderAddJPEGFrame: lossless JPEG recompression."""
        if self._frames:
            raise JXLError("JPEG frames cannot be mixed with image frames")
        self._frames.append((settings, "jpeg", bytes(jpeg_bytes)))

    def process_output(self) -> bytes:
        """JxlEncoderProcessOutput collapsed to one call: encodes every
        queued frame and returns the complete stream."""
        if self._output is not None:
            return self._output
        if not self._frames:
            raise JXLError("no frames queued")
        fs0, kind0, payload0 = self._frames[0]
        if kind0 == "jpeg":
            from ..jpeg.recompress import recompress_jpeg_vardct

            self._output = recompress_jpeg_vardct(payload0)
            return self._output
        from . import codestream as cs

        opts = fs0.options

        def opt(setting, default=None):
            v = opts.get(setting, -1)
            return default if v == -1 or setting not in opts else v

        effort = opt(SETTING_EFFORT, 5) or 5
        if len(self._frames) > 1:
            frames = [p for (_s, _k, p) in self._frames]
            data = cs.encode_animation(
                frames, lossless=fs0.lossless or bool(
                    opt(SETTING_MODULAR, 0) == 1),
                distance=fs0.distance if fs0.distance > 0 else 1.0,
                device=self.device)
        elif fs0.lossless or opt(SETTING_MODULAR, 0) == 1:
            gss = opt(SETTING_MODULAR_GROUP_SIZE, 1)
            data = cs.encode_lossless(
                payload0, effort=effort,
                group_size_shift=gss if gss is not None else 1,
                responsive=bool(opt(SETTING_RESPONSIVE, 0)))
        else:
            epf = opts.get(SETTING_EPF, -1)
            gab = opts.get(SETTING_GABORISH, -1)
            dots = opts.get(SETTING_DOTS, -1)
            patches = opts.get(SETTING_PATCHES, -1)
            data = cs.encode_lossy(
                payload0, distance=fs0.distance, effort=effort,
                resampling=opt(SETTING_RESAMPLING, 1) or 1,
                progressive=2 if opt(SETTING_PROGRESSIVE_AC, 0) else 1,
                photon_noise_iso=opts.get(SETTING_PHOTON_NOISE),
                noise=bool(opt(SETTING_NOISE, 0)),
                epf=None if epf == -1 else epf,
                gaborish=None if gab == -1 else bool(gab),
                dots=None if dots == -1 else bool(dots),
                patches=None if patches == -1 else bool(patches),
                device=self.device)
        if self.use_container:
            from ..io.container import wrap_codestream

            data = wrap_codestream(
                data, compress_boxes=bool(
                    opt(SETTING_JPEG_COMPRESS_BOXES, 1)))
        self._output = data
        return data
