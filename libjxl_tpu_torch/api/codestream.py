"""Top-level codestream encode/decode (signature | SizeHeader |
ImageMetadata | CustomTransformData | [ICC] | frames).

Mirrors lib/jxl/decode.cc:1009-1231 (header parsing order) and
lib/jxl/encode.cc:803-940 (writer). Container (ISOBMFF) handling lives in
libjxl_tpu.io.container.
"""

from __future__ import annotations

import numpy as np

from ..base.device import span, spanned
from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.frame_header import ENC_MODULAR, ENC_VARDCT, FrameHeader
from ..io.headers import CodecMetadata, CustomTransformData, ImageMetadata, SizeHeader
from .frame import (
    ModularEncOptions,
    decode_modular_frame,
    encode_modular_frame,
    make_modular_frame_header,
)

SIGNATURE = b"\xff\x0a"


def _calibrated_distance(distance: float) -> float:
    """Map the public --distance scale onto the internal quant scale.

    Round-3 state: after fixing the adaptive-quant field at the source
    (field computed pre-Gaborish like enc_heuristics.cc:1105, intra-block
    HfModulation diffs, the 0.39/d global-scale anchor, InitialQuantDC on
    the public distance, AdjustQuantField, learned DC trees), equal-
    butteraugli parity with the reference sits at a flat ~0.7x internal
    scale across d 0.5-3 (measured on textured/smooth/line corpora, see
    docs/RD_CURVE.md) — down from the round-2 0.5x + superlinear ramp
    patch. The residual 0.7 factor tracks our butteraugli comparator's
    absolute scale in the d -> quality mapping, not a field error."""
    return max(0.02, distance * 0.7)



def parse_codestream_header(r: BitReader) -> CodecMetadata:
    if r.read_bits(8) != 0xFF or r.read_bits(8) != 0x0A:
        raise JXLError("not a JPEG XL codestream (bad signature)")
    meta = CodecMetadata()
    meta.size = SizeHeader().read(r)
    meta.m = ImageMetadata().read(r)
    meta.transform_data = CustomTransformData(
        nonserialized_xyb_encoded=meta.m.xyb_encoded)
    meta.transform_data.read(r)
    if meta.m.color_encoding.want_icc:
        from ..io.icc import read_icc

        meta.m.color_encoding.icc = read_icc(r)
    r.jump_to_byte_boundary()
    return meta


def write_codestream_header(w: BitWriter, meta: CodecMetadata) -> None:
    w.write(8, 0xFF)
    w.write(8, 0x0A)
    meta.size.write(w)
    meta.m.write(w)
    meta.transform_data.nonserialized_xyb_encoded = meta.m.xyb_encoded
    meta.transform_data.write(w)
    if meta.m.color_encoding.want_icc:
        from ..io.icc import write_icc

        write_icc(meta.m.color_encoding.icc, w)
    w.zero_pad_to_byte()


# ----------------------------------------------------------------- image API
def encode_lossless(image: np.ndarray, bits_per_sample: int = None,
                    effort: int = 3, group_size_shift: int = 1,
                    icc: bytes = None, responsive: bool = False,
                    orientation: int = 1, predictor: int = None,
                    palette_colors: int = None, colorspace: int = None,
                    lossy_palette: bool = False,
                    ma_tree_learning_percent: float = None) -> bytes:
    """Encode an image losslessly (modular mode).

    image: (H, W) or (H, W, C) uint8/uint16/int array.
    icc: optional raw ICC profile to embed (signals want_icc).
    Returns a bare JPEG XL codestream.
    """
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, nc = image.shape
    if bits_per_sample is None:
        bits_per_sample = 16 if image.dtype == np.uint16 else 8
    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    meta.m.all_default = False
    meta.m.xyb_encoded = False
    if orientation != 1:
        # stored pixels are pre-orientation; the decoder re-applies it
        meta.m.orientation = orientation
    meta.m.bit_depth.bits_per_sample = bits_per_sample
    if bits_per_sample > 12:
        meta.m.modular_16_bit_buffer_sufficient = False
    if nc == 1:
        meta.m.color_encoding.all_default = False
        meta.m.color_encoding = meta.m.color_encoding.srgb(is_gray=True)
        meta.m.color_encoding.all_default = False
    if nc == 4:
        meta.m.set_alpha_bits(bits_per_sample)
    if icc is not None:
        meta.m.color_encoding.all_default = False
        meta.m.color_encoding.want_icc = True
        meta.m.color_encoding.icc = icc
    writer = BitWriter()
    write_codestream_header(writer, meta)
    fh = make_modular_frame_header(meta, group_size_shift=group_size_shift)
    channels = [image[:, :, c].astype(np.int32) for c in range(min(nc, 3))]
    if nc == 4:
        channels.append(image[:, :, 3].astype(np.int32))
    opts = ModularEncOptions(group_size_shift=group_size_shift,
                             color_transform=6 if nc >= 3 else None,
                             effort=effort, responsive=responsive)
    # cjxl expert modular knobs (cjxl_main.cc modular_* flags)
    if predictor is not None:
        opts.predictor = int(predictor)
        opts.force_predictor = True
    if palette_colors is not None:
        opts.max_palette_colors = int(palette_colors)
        opts.try_palette = palette_colors != 0
    if colorspace is not None:
        # -1 = encoder default; 0 = none; 1-41 = RCT type
        opts.color_transform = None if colorspace == 0 else (
            int(colorspace) if colorspace > 0 else opts.color_transform)
    if lossy_palette:
        opts.delta_palette = True
    if ma_tree_learning_percent is not None \
            and ma_tree_learning_percent > 0:
        # percent of samples fed to the CART learner -> sample step
        opts.tree_sample_step = max(1, int(round(
            100.0 / ma_tree_learning_percent)))
    encode_modular_frame(writer, channels, fh, opts)
    return writer.get_bytes()


def encode_cmyk(cmyk: np.ndarray, icc: bytes = None,
                effort: int = 3, group_size_shift: int = 1) -> bytes:
    """Encode a CMYK image losslessly (kBlack extra channel).

    cmyk: (H, W, 4) uint8/uint16 INK values (0 = no ink). Per the spec
    the stream stores trichromatic samples = 1 - ink for C, M, Y plus
    a kBlack extra channel = 1 - K ink (color_encoding_cms.h:40-43:
    the kBlack channel's presence IS the CMYK signal; jxl_cms.cc:235
    re-inverts for the CMS). icc: the CMYK ICC profile to embed
    (recommended — decoders need it for colorimetric meaning)."""
    from ..io.headers import EC_BLACK, ExtraChannelInfo

    if cmyk.ndim != 3 or cmyk.shape[2] != 4:
        raise JXLError("encode_cmyk needs (H, W, 4) ink samples")
    h, w, _ = cmyk.shape
    bits = 16 if cmyk.dtype == np.uint16 else 8
    maxval = (1 << bits) - 1
    inv = (maxval - cmyk.astype(np.int64)).astype(np.int32)
    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    meta.m.all_default = False
    meta.m.xyb_encoded = False
    meta.m.bit_depth.bits_per_sample = bits
    if bits > 12:
        meta.m.modular_16_bit_buffer_sufficient = False
    eci = ExtraChannelInfo()
    eci.set_default()
    eci.all_default = False
    eci.type = EC_BLACK
    eci.bit_depth.bits_per_sample = bits
    meta.m.extra_channel_info.append(eci)
    meta.m.num_extra_channels = 1
    if icc is not None:
        meta.m.color_encoding.all_default = False
        meta.m.color_encoding.want_icc = True
        meta.m.color_encoding.icc = icc
    writer = BitWriter()
    write_codestream_header(writer, meta)
    fh = make_modular_frame_header(meta, group_size_shift=group_size_shift)
    channels = [inv[:, :, c] for c in range(4)]
    opts = ModularEncOptions(group_size_shift=group_size_shift,
                             color_transform=6, effort=effort)
    encode_modular_frame(writer, channels, fh, opts)
    return writer.get_bytes()


def decode_cmyk(data: bytes, device="cuda"):
    """Decode a CMYK (kBlack) stream to (H, W, 4) ink samples + meta.
    Inverse of encode_cmyk: samples -> maxval - stored. device: as in
    decode()."""
    ink, meta = decode(data, color_management=False, device=device)
    if not any(e.type == 4 for e in meta.m.extra_channel_info):
        raise JXLError("stream has no kBlack channel")
    maxval = (1 << meta.m.bit_depth.bits_per_sample) - 1
    return (maxval - ink[:, :, :4].astype(np.int64)).astype(
        ink.dtype), meta


def encode_lossy(image: np.ndarray, distance: float = 1.0,
                 group_size_shift: int = 1,
                 photon_noise_iso: float = None,
                 noise: bool = False,
                 resampling: int = 1,
                 progressive: int = 1,
                 icc: bytes = None,
                 splines=None,
                 custom_quant: dict = None,
                 effort: int = 5,
                 preview: int = None,
                 spot_color=None,
                 stats: dict = None,
                 device="cuda",
                 gaborish: bool = None,
                 epf: int = None,
                 dots: bool = None,
                 patches: bool = None,
                 intensity_target: float = None,
                 iterations: int = None,
                 already_downsampled: bool = False,
                 progressive_dc: bool = False,
                 group_order: int = 0,
                 center_x: int = None, center_y: int = None,
                 debug_cb=None) -> bytes:
    """Encode an sRGB uint8 (H, W, 3|4) image lossily (VarDCT mode).

    A 4th channel is coded losslessly as an alpha extra channel
    (modular sub-streams, enc_modular.cc do_color=false path).
    photon_noise_iso: if set, signal synthetic photon noise (kNoise flag).
    icc: optional raw ICC profile to embed (signals want_icc; the pixel
    data is still XYB-coded, the profile describes the decode target).
    device: where the encode's device stages run: "cuda" by default (a
    missing card raises, base/device.resolve_device), "cpu" runs the same
    torch ops on the CPU (the kernels' plain twins), None is the host
    encode (the JAX package's device=False). At efforts <= 3 with none of
    the special features the compute path (XYB, inverse Gaborish,
    adaptive quant field, DCT, CfL, quantization) runs there
    (tpu_codec.encode_lossy_tpu) and only the entropy coding on the host.
    At effort >= 4 the AC-strategy tile costs run there, and at effort
    >= 7 (or with `iterations`) the butteraugli quant refinement too: a
    trial render through kernels.render_tail and the diffmap, each round;
    a preview frame's strategy search runs there at any effort. A
    featured encode at effort <= 3 without a preview runs wholly on the
    host, whatever the device."""
    from ..io.frame_header import (
        FLAG_NOISE,
        FLAG_SKIP_ADAPTIVE_DC_SMOOTHING,
        FT_REGULAR,
        ENC_VARDCT,
        CT_XYB,
        FrameHeader,
    )
    from ..ops.xyb import srgb_to_linear, srgb_u8_to_linear
    from ..vardct.frame import encode_vardct_frame

    # the device route: at the DCT8 efforts (<= e3, the "XYB jpeg" tier)
    # with no special coding features (enc_group.cc's SIMD loops against
    # enc_ans.cc's stream writing)
    if (device is not None and effort <= 3 and distance > 0
            and image.ndim == 3 and image.shape[2] == 3
            and image.dtype == np.uint8
            and icc is None and photon_noise_iso is None and not noise
            and resampling == 1 and progressive == 1 and preview is None
            and splines is None and custom_quant is None
            and spot_color is None and stats is None and debug_cb is None
            and dots is None and patches is None):
        from .tpu_codec import encode_lossy_tpu

        return encode_lossy_tpu(image, distance=distance,
                                gaborish=gaborish, epf=epf, device=device)
    # the strategy search (e >= 4, and a preview frame's at any effort)
    # and the butteraugli refinement (e >= 7, or `iterations`) run on the
    # device; no other host encode needs it
    if device is not None and (effort >= 4 or preview or iterations):
        from ..base.device import resolve_device

        device = resolve_device(device)
    else:
        device = None
    public_distance = distance
    distance = _calibrated_distance(distance)
    if image.ndim == 2:
        image = image[:, :, None]
    if image.shape[2] == 1:
        # grayscale: code as three identical channels (the XYB path is
        # inherently 3-channel; X ends up ~0 and CfL removes B redundancy)
        image = np.repeat(image, 3, axis=2)
    h, w, nc = image.shape
    extra_channels = None
    meta = CodecMetadata()
    if already_downsampled and resampling > 1:
        # input pixels are the low-res frame; the signaled image size is
        # the upsampled one (cjxl --already_downsampled semantics)
        meta.size = SizeHeader().set(w * resampling, h * resampling)
    else:
        meta.size = SizeHeader().set(w, h)
    if image.dtype == np.uint16:
        # HDR/deep input: signal 16-bit samples (the XYB payload is the
        # same; bit depth governs the decoder's output quantization)
        meta.m.all_default = False
        meta.m.bit_depth.bits_per_sample = 16
    if intensity_target is not None:
        # display brightness the stream targets (tone_mapping bundle;
        # drives the decoder's Rec.2408 stage and HDR intent)
        meta.m.all_default = False
        meta.m.tone_mapping.all_default = False
        meta.m.tone_mapping.intensity_target = float(intensity_target)
    if nc == 4:
        meta.m.all_default = False
        meta.m.set_alpha_bits(8 if image.dtype == np.uint8 else 16)
        extra_channels = [image[:, :, 3].astype(np.int32)]
        image = image[:, :, :3]
    if spot_color is not None:
        # (plane uint8 HxW, (r, g, b, a)) -> EC_SPOT_COLOR channel
        # rendered by the decoder's spot stage (stage_spot.cc)
        from ..io.headers import EC_SPOT_COLOR, ExtraChannelInfo

        plane, rgba = spot_color
        eci = ExtraChannelInfo()
        eci.set_default()
        eci.all_default = False
        eci.type = EC_SPOT_COLOR
        eci.spot_color = [float(v) for v in rgba]
        meta.m.all_default = False
        meta.m.extra_channel_info.append(eci)
        meta.m.num_extra_channels = len(meta.m.extra_channel_info)
        extra_channels = (extra_channels or []) + [
            np.asarray(plane, dtype=np.int32)]
    cms_linear = None
    if icc is not None:
        # CMS: pixels carrying a non-sRGB ICC profile are converted to
        # linear sRGB before XYB (cms/jxl_cms.cc role; lcms2 backend)
        # and the profile is EMBEDDED as the stream's color encoding —
        # the decoder's CMS stage (stage_cms.cc) converts back into it
        # on request (decode(color_management=True) / djxl
        # --color_management). Without lcms2 the profile is embedded
        # untouched and the pixels are coded as-is.
        from ..extras import cms as _cms

        if _cms.available() and _cms.profile_is_rgb(icc):
            cms_linear = np.moveaxis(
                _cms.icc_to_linear_srgb(image, icc), -1, 0).astype(
                    np.float64)
        elif _cms.available() and _cms.profile_is_gray(icc):
            # gray input leg (jxl_cms.cc gray handling): samples carry a
            # GRAY ICC profile; expand through lcms to linear sRGB
            cms_linear = np.moveaxis(
                _cms.gray_icc_to_linear_srgb(image, icc), -1, 0).astype(
                    np.float64)
        else:
            # no CMS (or unsupported profile class): pixels stay in
            # profile space but the stream still signals the profile —
            # a CMS-capable decoder will re-convert (double transform).
            # Loud, because this producer is non-conforming.
            import logging

            logging.getLogger("libjxl_tpu.cms").warning(
                "encoding with an ICC profile but %s: pixels are coded "
                "unconverted; decoders applying the CMS stage will "
                "double-convert",
                "lcms2 unavailable" if not _cms.available()
                else "unsupported profile class")
        meta.m.all_default = False
        meta.m.color_encoding.all_default = False
        meta.m.color_encoding.want_icc = True
        meta.m.color_encoding.icc = icc
    pv_img = None
    if preview:
        # downscale so the long side fits `preview` px (8px multiples)
        from ..render.upsample import downsample_box

        scale = 1
        while max(h, w) // (scale * 2) >= preview:
            scale *= 2
        ph_, pw_ = max(8, (h // scale) // 8 * 8), max(8, (w // scale) // 8 * 8)
        meta.m.all_default = False
        meta.m.have_preview = True
        meta.m.preview_size.div8 = False
        meta.m.preview_size.ratio = 0
        meta.m.preview_size.ysize_ = ph_
        meta.m.preview_size.xsize_ = pw_
        lin = (srgb_u8_to_linear(image) if image.dtype == np.uint8
           else srgb_to_linear(image.astype(np.float64) / 255.0))
        lin = np.moveaxis(lin, -1, 0)
        small = np.stack([downsample_box(lin[c], scale) for c in range(3)])
        pv_img = small[:, :ph_, :pw_]
        # every frame carries the signaled extra channels
        pv_extra = None
        if extra_channels:
            pv_extra = [
                np.round(downsample_box(e.astype(np.float64), scale)
                         [:ph_, :pw_]).astype(np.int32)
                for e in extra_channels]
    writer = BitWriter()
    write_codestream_header(writer, meta)
    if pv_img is not None:
        pfh = FrameHeader(meta)
        pfh.nonserialized_is_preview = True
        pfh.all_default = False
        pfh.frame_type = FT_REGULAR
        pfh.encoding = ENC_VARDCT
        pfh.color_transform = CT_XYB
        pfh.flags = FLAG_SKIP_ADAPTIVE_DC_SMOOTHING
        pfh.is_last = False
        pfh.loop_filter.all_default = False
        pfh.loop_filter.gab = True
        pfh.loop_filter.epf_iters = 0
        encode_vardct_frame(writer, pv_img, pfh,
                            distance=max(distance, 1.5),
                            extra_channels=pv_extra, device=device)
        writer.zero_pad_to_byte()
    fh = FrameHeader(meta)
    fh.all_default = False
    fh.frame_type = FT_REGULAR
    fh.encoding = ENC_VARDCT
    fh.color_transform = CT_XYB
    # adaptive DC smoothing enabled (flag clear): the decoder-side 3x3
    # DC filter averages out DC quantization noise on smooth content
    # (dc_dec smoothing, dec_frame.cc AdaptiveDCSmoothing) — measured
    # -29% rms / -0.2 butteraugli on smooth gradients at d3, neutral on
    # textured content
    fh.flags = 0
    noise_lut = None
    if photon_noise_iso is not None:
        from ..render.noise import photon_noise_lut

        noise_lut = photon_noise_lut(photon_noise_iso, w, h)
    fh.loop_filter.all_default = False
    # decoder blurs; encoder pre-sharpens (default on, like the ref)
    fh.loop_filter.gab = True if gaborish is None else bool(gaborish)
    # reference default epf_iters = 2 (loop_filter.cc:56)
    fh.loop_filter.epf_iters = 2 if epf is None else max(0, min(3, epf))
    fh.upsampling = resampling
    if progressive > 1:
        fh.passes.num_passes = progressive
        fh.passes.shift = [progressive - 1 - i for i in range(progressive)] \
            + [0] * (11 - progressive)
    if cms_linear is not None:
        rgb = cms_linear
    else:
        in_scale = 65535.0 if image.dtype == np.uint16 else 255.0
        rgb = (srgb_u8_to_linear(image) if image.dtype == np.uint8
           else srgb_to_linear(image.astype(np.float64) / in_scale))
        rgb = np.moveaxis(rgb, -1, 0)
    if noise and noise_lut is None:
        # content-based estimation (GetNoiseParameter, enc_noise.cc:328)
        from ..ops.xyb import linear_rgb_to_xyb
        from ..render.noise import estimate_noise

        noise_lut = estimate_noise(linear_rgb_to_xyb(rgb))
    if noise_lut is not None:
        fh.flags |= FLAG_NOISE
    if resampling > 1 and already_downsampled:
        # cjxl --already_downsampled: the input IS the low-res frame;
        # only signal the upsampling factor (SizeHeader keeps the full
        # output size, so the caller passed H/N x W/N pixels). Extra
        # channels are at the same low resolution, so they signal the
        # same factor (ec_upsampling >= upsampling, frame_header.cc)
        if extra_channels:
            fh.extra_channel_upsampling = \
                [resampling] * len(extra_channels)
    elif resampling > 1:
        from ..render.upsample import (
            downsample2_iterative,
            downsample2_sharper,
            downsample_box,
        )

        if resampling == 2:
            # effort tiers mirror enc_frame.cc:695-706: squirrel+ runs
            # the iterative error-feedback downsampler, faster efforts
            # the 12x12 sharper kernel; both beat box filtering for 2x
            ds2 = downsample2_iterative if effort >= 7 else \
                downsample2_sharper
            rgb = np.stack([ds2(rgb[c]) for c in range(3)])
        else:
            rgb = np.stack([downsample_box(rgb[c], resampling)
                            for c in range(3)])
        if extra_channels:
            # extra channels must be upsampled at least as much as the
            # color channels (frame_header.cc ec_upsampling >= upsampling)
            fh.extra_channel_upsampling = [resampling] * len(extra_channels)
            extra_channels = [
                np.round(downsample_box(ec.astype(np.float64),
                                        resampling)).astype(np.int32)
                for ec in extra_channels]
    # effort semantics (doc/encode_effort.md): kitten (e7) and up run the
    # Butteraugli-feedback quant refinement (<= 4 iters, like the ref);
    # e8+ also runs dot detection (FindBestPatchDictionary dot path)
    butteraugli_iters = 0 if effort < 7 else min(4, effort - 5)
    if iterations is not None:  # cjxl --iterations override
        butteraugli_iters = max(0, min(10, int(iterations)))
    if progressive_dc and resampling > 1:
        # the kDCFrame dimension formula divides by BOTH 8^dc_level and
        # the frame's upsampling (frame_header.h:466-483); the
        # cross-term semantics have no reference-emitted sample to pin
        # against, so refuse to emit the combination rather than risk
        # an invalid stream (found by the encoder soak: the previous
        # behavior wrote a stream both decoders rejected)
        import logging

        logging.getLogger("libjxl_tpu.encode").warning(
            "progressive_dc + resampling is not supported; coding DC "
            "in-frame")
        progressive_dc = False
    encode_vardct_frame(writer, rgb, fh, distance=distance,
                        use_dc_frame=progressive_dc,
                        group_order=group_order,
                        center_x=center_x, center_y=center_y,
                        noise_lut=noise_lut, splines=splines,
                        extra_channels=extra_channels,
                        custom_quant=custom_quant,
                        butteraugli_iters=butteraugli_iters,
                        detect_dots=effort >= 8 if dots is None else dots,
                        detect_patches=(effort >= 7 if patches is None
                                        else patches),
                        ctx_model=effort >= 6,
                        effort=effort,
                        dc_distance=public_distance,
                        debug_cb=debug_cb, device=device)
    if stats is not None:
        from .stats import collect_stats

        stats.update(collect_stats(writer))
    return writer.get_bytes()


def encode_lossy_streaming(image_or_chunks, width: int = None,
                           height: int = None, distance: float = 1.0,
                           hosts: int = 1, mesh=None,
                           device="cuda") -> bytes:
    """Streaming VarDCT encode: one 2048x2048 DC group at a time with
    bounded memory (EncodeFrameStreaming analog, enc_frame.cc:1975).

    image_or_chunks: either an (H, W, 3) uint8 sRGB array, or a callable
    get_chunk(px0, py0, w, h) -> (3, h, w) linear RGB float (with
    width/height given). hosts > 1 encodes disjoint DC-group slices in
    parallel — the multi-host decomposition demo. device: where each DC
    group's pixel math runs, "cuda" by default (a missing card raises) or
    "cpu"; there is no host route (the JAX package always ran this step
    as a device program), so None raises ValueError. mesh: a
    parallel/sharding.Mesh over which each DC group's quantize/DCT/CfL
    step runs with its rows sharded, byte-identical to the sequential
    encode."""
    if device is None:
        raise ValueError("encode_lossy_streaming runs its DC-group step "
                         "on a torch device; device=None has no host "
                         "route")
    public_distance = distance
    distance = _calibrated_distance(distance)
    from ..io.frame_header import (
        CT_XYB,
        ENC_VARDCT,
        FLAG_SKIP_ADAPTIVE_DC_SMOOTHING,
        FT_REGULAR,
        FrameHeader,
    )
    from ..ops.xyb import srgb_to_linear, srgb_u8_to_linear
    from ..vardct.streaming import encode_vardct_frame_streaming

    if callable(image_or_chunks):
        get_chunk = image_or_chunks
        if width is None or height is None:
            raise ValueError("width/height required with a chunk provider")
        w_, h_ = width, height
    else:
        img = image_or_chunks
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        h_, w_ = img.shape[:2]
        # extra channels are not part of the streaming path (v1)
        rgb_full = np.moveaxis(
            srgb_to_linear(img[:, :, :3].astype(np.float64) / 255.0), -1, 0)
        pad_y = (-h_) % 8
        pad_x = (-w_) % 8
        rgb_full = np.pad(rgb_full, ((0, 0), (0, pad_y), (0, pad_x)),
                          mode="edge")

        def get_chunk(px0, py0, cw, ch):
            return rgb_full[:, py0:py0 + ch, px0:px0 + cw]

    meta = CodecMetadata()
    meta.size = SizeHeader().set(w_, h_)
    writer = BitWriter()
    write_codestream_header(writer, meta)
    fh = FrameHeader(meta)
    fh.all_default = False
    fh.frame_type = FT_REGULAR
    fh.encoding = ENC_VARDCT
    fh.color_transform = CT_XYB
    fh.flags = 0  # adaptive DC smoothing on (see encode_lossy)
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = True
    fh.loop_filter.epf_iters = 2
    encode_vardct_frame_streaming(writer, get_chunk, fh, distance=distance,
                                  hosts=hosts, mesh=mesh,
                                  dc_distance=public_distance,
                                  device=device)
    return writer.get_bytes()


def _stash_reference_frame(r, fh, meta, reference_frames,
                           reference_extra):
    """Decode one kReferenceOnly frame (VarDCT or modular) and stash it
    at the reference decoder's storage scale (see decode())."""
    from ..vardct.frame import decode_vardct_frame

    if fh.encoding == ENC_MODULAR:
        from ..io.frame_header import CT_XYB as _CT_XYB_R

        img = decode_modular_frame(r, fh, reference_frames)
        num_ec = len(meta.m.extra_channel_info)
        nb = len(img.channel) - num_ec
        if fh.color_transform == _CT_XYB_R:
            chy = img.channel[0].data.astype(np.float64)
            chx = img.channel[1].data.astype(np.float64)
            chb = img.channel[2].data.astype(np.float64)
            dq = img.dc_quant
            reference_frames[fh.save_as_reference] = np.stack(
                [chx * dq[0], chy * dq[1], (chb + chy) * dq[2]])
        else:
            mv = (1 << meta.m.bit_depth.bits_per_sample) - 1
            reference_frames[fh.save_as_reference] = np.stack(
                [img.channel[c].data.astype(np.float64)
                 for c in range(nb)]) / mv
        if num_ec:
            reference_extra[fh.save_as_reference] = [
                img.channel[nb + k].data.astype(np.float64)
                / ((1 << meta.m.extra_channel_info[k]
                    .bit_depth.bits_per_sample) - 1)
                for k in range(num_ec)]
        return
    ref_ec = []
    xyb = decode_vardct_frame(r, fh, reference_frames,
                              return_xyb=True, extra_out=ref_ec)
    reference_frames[fh.save_as_reference] = xyb
    if ref_ec:
        # normalized [0, 1] planes for alpha-blend sources
        maxvals = [
            (1 << (meta.m.extra_channel_info[k]
                   .bit_depth.bits_per_sample
                   if k < len(meta.m.extra_channel_info) else 8)) - 1
            for k in range(len(ref_ec))]
        reference_extra[fh.save_as_reference] = [
            np.asarray(e, dtype=np.float64) / mv
            for e, mv in zip(ref_ec, maxvals)]


@spanned("jxl.decode")
def decode(data: bytes, target_nits: float = None,
           num_threads: int = 0, device="cuda",
           decode_info: dict = None, color_management: bool = None,
           pixel_format: str = None):
    """Decode a bare codestream. Returns (image ndarray HxWxC, CodecMetadata).

    pixel_format: None (default) emits uint8/uint16 by the stream's bit
    depth; "float32"/"float16" emit sRGB-transfer floats in [0, 1]
    (extra channels normalized), the JXL_TYPE_FLOAT/FLOAT16 output
    legs of the reference API (types.h:46,57). Float output takes the
    sRGB leg (no CMS re-quantization).

    Only the first frame is returned; animation frames via decode_frames.
    target_nits: when set and below the stream's intensity target, the
    Rec.2408 tone-mapping stage runs (stage_tone_mapping.cc analog).
    color_management: convert the decoded pixels INTO the stream's
    embedded ICC profile space (the decoder-side CMS stage,
    stage_cms.cc; lcms2 backend). Default (None) = auto: applied
    whenever an RGB ICC profile is embedded — the signaled color
    encoding IS the decoder's output space, matching djxl. Pass False
    to force plain sRGB output.
    device: a torch device, "cuda" by default, renders each VarDCT
    frame's pixel pipeline there (tpu_codec.make_device_render: dequant +
    the IDCT zoo + Gaborish/EPF + the write stage), falling back to the
    host, loudly, on unsupported features; "cpu" runs the same render on
    the CPU. None renders on the host (NumPy and native C). There is no
    accelerator probe: "cuda" with no card raises. decode_info: pass a dict to receive {"path": ...}
    recording which renderer produced the pixels.
    """
    from ..io.frame_header import FT_DC, FT_REFERENCE_ONLY
    from ..ops.xyb import linear_to_srgb
    from ..vardct.frame import decode_vardct_frame

    from ..io.container import extract_codestream, is_container

    if device is not None:
        from ..base.device import resolve_device

        device = resolve_device(device)
    if is_container(data):
        # container-transparent like JxlDecoderProcessInput: pull the
        # codestream out of the jxlc/jxlp boxes (io/container.py)
        data = extract_codestream(data)
    if pixel_format not in (None, "float32", "float16"):
        raise JXLError(f"unsupported pixel_format {pixel_format!r}")
    want_float = pixel_format is not None
    r = BitReader(data)
    with span("jxl.headers"):
        meta = parse_codestream_header(r)
    bits = meta.m.bit_depth.bits_per_sample
    if want_float:
        color_management = False  # float output takes the sRGB leg
    if color_management is None:
        # the signaled color encoding IS the decoder's output space:
        # apply the CMS stage automatically for embedded RGB profiles
        color_management = bool(meta.m.color_encoding.want_icc
                                and meta.m.xyb_encoded)
    if meta.m.have_preview:
        _skip_or_decode_preview(r, meta)
    reference_frames = [None] * 4
    reference_extra = [None] * 4
    dc_frames = [None] * 5  # by dc_level (kUseDcFrame pyramid)
    while True:
        with span("jxl.headers"):
            fh = FrameHeader(meta)
            fh.read(r)
        if fh.frame_type == FT_DC:
            # 1:8 DC frame for the next frame (frame_header.h:348);
            # the reference codes it MODULAR by default (XYB ints =
            # YX(B-Y) scaled by the DC quants, dec_modular.cc:553-600)
            if fh.upsampling != 1:
                raise JXLError("DC frame with upsampling: unsupported")
            if fh.encoding == ENC_MODULAR:
                img = decode_modular_frame(r, fh, reference_frames)
                chy = img.channel[0].data.astype(np.float64)
                chx = img.channel[1].data.astype(np.float64)
                chb = img.channel[2].data.astype(np.float64)
                dq = img.dc_quant
                dc_frames[fh.dc_level] = np.stack(
                    [chx * dq[0], chy * dq[1], (chb + chy) * dq[2]])
            else:
                dc_frames[fh.dc_level] = decode_vardct_frame(
                    r, fh, reference_frames, return_xyb=True,
                    dc_frames=dc_frames)
            r.jump_to_byte_boundary()
            continue
        if fh.frame_type == FT_REFERENCE_ONLY:
            # decode and stash pre-color-transform; not displayed
            _stash_reference_frame(r, fh, meta, reference_frames,
                                   reference_extra)
            r.jump_to_byte_boundary()
            continue
        break
    def _orient(img_arr):
        if meta.m.orientation != 1:
            from ..extras.exif import apply_orientation

            return np.ascontiguousarray(
                apply_orientation(img_arr, meta.m.orientation))
        return img_arr

    if fh.encoding == ENC_MODULAR:
        if decode_info is not None:
            decode_info["path"] = "host:modular"
        img = decode_modular_frame(r, fh, reference_frames,
                                   reference_extra)
        from ..io.frame_header import CT_XYB as _CT_XYB_M

        if meta.m.xyb_encoded and fh.color_transform == _CT_XYB_M:
            # lossy-modular main frame: ints are YX(B-Y) scaled by the
            # signaled DC quants (dec_modular.cc:553-600); convert to
            # XYB, run restoration if signaled, then the regular XYB
            # output conversion
            chy = img.channel[0].data.astype(np.float64)
            chx = img.channel[1].data.astype(np.float64)
            chb = img.channel[2].data.astype(np.float64)
            dq = img.dc_quant
            xyb = np.stack([chx * dq[0], chy * dq[1],
                            (chb + chy) * dq[2]])
            if fh.loop_filter.gab or fh.loop_filter.epf_iters > 0:
                from ..render.pipeline import (apply_epf_modular,
                                               apply_gaborish)

                if fh.loop_filter.gab:
                    xyb = apply_gaborish(xyb, fh.loop_filter)
                if fh.loop_filter.epf_iters > 0:
                    xyb = apply_epf_modular(xyb, fh.loop_filter)
            from ..ops.xyb import linear_to_srgb_u8, xyb_to_linear_rgb

            rgbm = np.clip(xyb_to_linear_rgb(xyb), 0.0, 1.0)
            rgbm = np.moveaxis(rgbm, 0, -1)
            ec_m = [img.channel[3 + k].data
                    for k in range(len(img.channel) - 3)]
            if want_float:
                fdt = np.float32 if pixel_format == "float32" \
                    else np.float16
                outf = linear_to_srgb(rgbm)
                if ec_m:
                    scales = [
                        (1 << meta.m.extra_channel_info[k]
                         .bit_depth.bits_per_sample) - 1
                        for k in range(len(ec_m))]
                    outf = np.concatenate(
                        [outf] + [(e / sc)[:, :, None]
                                  for e, sc in zip(ec_m, scales)],
                        axis=-1)
                return _orient(outf.astype(fdt)), meta
            if bits <= 8:
                out_m = linear_to_srgb_u8(rgbm)
                if ec_m:
                    out_m = np.concatenate(
                        [out_m] + [np.clip(e, 0, 255).astype(
                            np.uint8)[:, :, None] for e in ec_m],
                        axis=-1)
                return _orient(out_m), meta
            mvm = (1 << min(bits, 16)) - 1
            srgbm = np.clip(np.round(linear_to_srgb(rgbm) * mvm), 0,
                            mvm).astype(np.uint16)
            if ec_m:
                srgbm = np.concatenate(
                    [srgbm] + [np.clip(e, 0, 65535).astype(
                        np.uint16)[:, :, None] for e in ec_m],
                    axis=-1)
            return _orient(srgbm), meta
        chans = [c.data for c in img.channel]
        stacked = np.stack(chans, axis=-1)
        from ..io.headers import EC_BLACK as _EC_BLACK

        has_black = any(e.type == _EC_BLACK
                        for e in meta.m.extra_channel_info)
        if has_black and color_management and stacked.shape[2] >= 4:
            # CMYK leg (color_encoding_cms.h:40-43): stored samples are
            # 1 - ink; convert through the embedded CMYK profile when
            # lcms is present, else the naive formula
            mv = (1 << bits) - 1
            ink = np.clip(1.0 - stacked[:, :, :4] / mv, 0.0, 1.0)
            from ..extras import cms as _cms
            from ..ops.xyb import linear_to_srgb_u8

            icc_prof = meta.m.color_encoding.icc \
                if meta.m.color_encoding.want_icc else None
            if icc_prof is not None and _cms.available() \
                    and _cms.profile_is_cmyk(icc_prof):
                lin = _cms.cmyk_icc_to_linear_srgb(ink, icc_prof)
            else:
                # naive: rgb = (1 - c)(1 - k), nonlinear sRGB values
                srgb = ((1.0 - ink[:, :, :3])
                        * (1.0 - ink[:, :, 3:4]))
                return _orient(np.clip(np.round(srgb * 255.0), 0,
                                       255).astype(np.uint8)), meta
            return _orient(linear_to_srgb_u8(lin)), meta
        if want_float:
            num_ec = len(meta.m.extra_channel_info)
            nb = stacked.shape[2] - num_ec
            scale = np.empty(stacked.shape[2])
            scale[:nb] = (1 << bits) - 1
            for k in range(num_ec):
                scale[nb + k] = (1 << meta.m.extra_channel_info[k]
                                 .bit_depth.bits_per_sample) - 1
            fdt = np.float32 if pixel_format == "float32" else np.float16
            return _orient((stacked / scale).astype(fdt)), meta
        if bits <= 8:
            return _orient(stacked.astype(np.uint8)), meta
        if bits <= 16:
            return _orient(stacked.astype(np.uint16)), meta
        return _orient(stacked), meta
    runner = None
    if num_threads > 1:
        from ..parallel.runner import ThreadParallelRunner

        runner = ThreadParallelRunner(num_threads)
    render_fn = None
    out = decode_info if decode_info is not None else {}
    out.setdefault("path", "host")
    if device is not None:
        from .tpu_codec import make_device_render

        # the direct u8 write stage only applies when no host post-stage
        # (tone map / CMS / spot colors / >8-bit output) needs the floats
        from ..io.frame_header import CT_YCBCR as _CT_YCBCR_W

        out["want_u8"] = (target_nits is None and bits <= 8
                          and not want_float
                          and (meta.m.xyb_encoded
                               or fh.color_transform == _CT_YCBCR_W)
                          and meta.m.orientation == 1
                          and not color_management)
        render_fn = make_device_render(fh, out, device)
    extra = []
    chans = decode_vardct_frame(r, fh, reference_frames, extra_out=extra,
                                reference_extra=reference_extra,
                                dc_frames=dc_frames, runner=runner,
                                render_fn=render_fn,
                                want_qimg=device is not None,
                                num_threads=num_threads)
    if chans is None and "u8" in out:
        # the whole pipeline, the sRGB u8 write stage included, ran on
        # the device
        return _orient(out["u8"]), meta
    # spot-color channels are rendered into the color image and removed
    # from the output (stage_spot.cc)
    from ..io.headers import EC_SPOT_COLOR

    if any(e.type == EC_SPOT_COLOR for e in meta.m.extra_channel_info):
        from ..render.tone_map import apply_spot_colors

        rgb_planes = np.stack(chans)
        rgb_planes = apply_spot_colors(rgb_planes, extra,
                                       meta.m.extra_channel_info)
        chans = [rgb_planes[c] for c in range(3)]
        extra = [e for k, e in enumerate(extra)
                 if k >= len(meta.m.extra_channel_info)
                 or meta.m.extra_channel_info[k].type != EC_SPOT_COLOR]
    if target_nits is not None:
        source_nits = getattr(meta.m.tone_mapping, "intensity_target",
                              255.0) or 255.0
        if source_nits > target_nits:
            from ..render.tone_map import rec2408_tone_map

            planes = rec2408_tone_map(np.stack(chans), source_nits,
                                      target_nits)
            chans = [planes[c] for c in range(3)]
    rgb = np.stack(chans, axis=-1)
    # decoder-side CMS stage (stage_cms.cc): convert the linear pixels
    # into the embedded ICC profile's space when asked
    if color_management and meta.m.xyb_encoded \
            and meta.m.color_encoding.want_icc:
        from ..extras import cms as _cms

        icc_prof = meta.m.color_encoding.icc
        if _cms.available() and _cms.profile_is_rgb(icc_prof):
            out_px = _cms.linear_srgb_to_icc(np.clip(rgb, 0.0, 1.0),
                                             icc_prof)
            if decode_info is not None:
                decode_info["cms"] = "applied"
            return _finish_cms_output(out_px, extra, bits, meta,
                                      _orient)
        if _cms.available() and _cms.profile_is_gray(icc_prof):
            # gray output leg: convert into the GRAY profile's space and
            # replicate to 3 channels for the RGB output contract
            g = _cms.linear_srgb_to_gray_icc(np.clip(rgb, 0.0, 1.0),
                                             icc_prof)
            if decode_info is not None:
                decode_info["cms"] = "applied-gray"
            out_px = np.repeat(g[:, :, None], 3, axis=2)
            return _finish_cms_output(out_px, extra, bits, meta,
                                      _orient)
        import logging

        logging.getLogger("libjxl_tpu.cms").warning(
            "color_management requested but %s; returning sRGB",
            "lcms2 unavailable" if not _cms.available()
            else "profile is not RGB")
    if want_float:
        fdt = np.float32 if pixel_format == "float32" else np.float16
        outf = linear_to_srgb(np.clip(rgb, 0.0, 1.0)) \
            if meta.m.xyb_encoded else np.clip(rgb, 0.0, 1.0)
        if extra:
            scales = [
                (1 << (meta.m.extra_channel_info[k]
                       .bit_depth.bits_per_sample
                       if k < len(meta.m.extra_channel_info) else 8)) - 1
                for k in range(len(extra))]
            ecs = np.stack([np.asarray(e, dtype=np.float64) / s
                            for e, s in zip(extra, scales)], axis=-1)
            outf = np.concatenate([outf, ecs], axis=-1)
        return _orient(outf.astype(fdt)), meta
    # non-XYB VarDCT frames (YCbCr/None) carry display-space values
    if bits <= 8:
        from ..ops.xyb import linear_to_srgb_u8

        if meta.m.xyb_encoded:
            # transfer function + quantization fused into one threshold
            # search (no full-image pow)
            out = linear_to_srgb_u8(rgb)
        else:
            out = np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
        if extra:
            ec = np.stack([np.clip(np.round(e), 0, 255).astype(np.uint8)
                           for e in extra], axis=-1)
            out = np.concatenate([out, ec], axis=-1)
        return _orient(out), meta
    srgb = linear_to_srgb(rgb) if meta.m.xyb_encoded else rgb
    if bits <= 16 and not meta.m.bit_depth.floating_point_sample:
        # integer deep output: quantize like the u8 leg (u16 samples)
        mv = (1 << bits) - 1
        out16 = np.clip(np.round(srgb * mv), 0, mv).astype(np.uint16)
        if extra:
            ec = np.stack([np.clip(np.round(e), 0, 65535).astype(
                np.uint16) for e in extra], axis=-1)
            out16 = np.concatenate([out16, ec], axis=-1)
        return _orient(out16), meta
    if extra:
        srgb = np.concatenate(
            [srgb] + [e[:, :, None].astype(srgb.dtype) for e in extra],
            axis=-1)
    return _orient(srgb), meta


def _skip_or_decode_preview(r: BitReader, meta, want: bool = False):
    """Read the preview frame that precedes the first regular frame when
    metadata.have_preview (dec_frame.cc InitFrame is_preview path)."""
    from ..vardct.frame import decode_vardct_frame

    fh = FrameHeader(meta)
    fh.nonserialized_is_preview = True
    fh.read(r)
    chans = decode_vardct_frame(r, fh)
    r.jump_to_byte_boundary()
    if not want:
        return None
    from ..ops.xyb import linear_to_srgb_u8

    return linear_to_srgb_u8(np.stack(chans, axis=-1))


def _finish_cms_output(out_px, extra, bits, meta, orient):
    """Attach extra channels and quantize the CMS stage's float pixels
    (both CMS legs share this; extras must never be dropped)."""
    if bits <= 8:
        u8 = np.clip(np.round(out_px * 255.0), 0, 255).astype(np.uint8)
        if extra:
            ec = np.stack([np.clip(np.round(e), 0, 255).astype(np.uint8)
                           for e in extra], axis=-1)
            u8 = np.concatenate([u8, ec], axis=-1)
        return orient(u8), meta
    if extra:
        out_px = np.concatenate(
            [out_px] + [np.asarray(e)[:, :, None].astype(out_px.dtype)
                        for e in extra], axis=-1)
    return orient(out_px), meta


def decode_batch(streams, num_threads: int = 0, device="cuda"):
    """Decode a list of codestreams. Returns a list of uint8 images in
    input order.

    device None decodes each stream on the host. A torch device ("cuda"
    by default; a missing card raises) batches same-geometry all-DCT8 streams into one render there
    (tpu_codec.decode_batch; lists longer than one batch of 16 run through
    the two-deep entropy/render pipeline, tpu_codec.decode_pipelined).
    When the list is not one such batch, the streams are bucketed by
    (xsize, ysize): each bucket of two or more is batched, and singletons,
    buckets outside the batch scope and streams that fail to parse decode
    one by one through decode(..., device=device)."""
    if device is None:
        return [decode(s, num_threads=num_threads, device=None)[0]
                for s in streams]
    from ..base.device import resolve_device
    from . import tpu_codec

    dev = resolve_device(device)
    if not streams:
        return []

    def batched(sub):
        if len(sub) > 16:
            return tpu_codec.decode_pipelined(sub, dev, batch_size=16,
                                              num_threads=num_threads)
        return tpu_codec.decode_batch(sub, dev, num_threads=num_threads)

    try:
        return batched(streams)
    except JXLError:
        pass  # heterogeneous / feature-gated: bucket by geometry
    # mixed fleets: group same-(W, H) streams and batch each bucket (the
    # batching is an optimization, never a behavior change)
    buckets = {}
    for i, s in enumerate(streams):
        try:
            meta = parse_codestream_header(BitReader(s))
            key = (meta.size.xsize(), meta.size.ysize())
        except JXLError:
            key = ("bad", i)
        buckets.setdefault(key, []).append(i)
    out = [None] * len(streams)
    for idxs in buckets.values():
        if len(idxs) >= 2:
            try:
                imgs = batched([streams[i] for i in idxs])
            except JXLError:
                pass
            else:
                for i, im in zip(idxs, imgs):
                    out[i] = im
                continue
        for i in idxs:
            out[i] = decode(streams[i], num_threads=num_threads,
                            device=dev)[0]
    return out


def decode_dc(data: bytes):
    """Fast 1:8 preview decode: only the DC sections are entropy-decoded
    (TOC random access; AC groups are never touched), the smoothed DC
    converts XYB->sRGB u8 at 1/8 resolution — djxl --downsampling 8 /
    the JXL_DEC_FRAME_PROGRESSION DC stage. Returns (u8 (H/8, W/8, 3),
    meta). VarDCT single-frame streams only; raises JXLError otherwise.
    """
    from ..io.container import extract_codestream, is_container
    from ..io.frame_header import ENC_MODULAR as _MOD, FT_REGULAR
    from ..io.toc import read_group_offsets
    from ..ops.xyb import linear_to_srgb_u8, xyb_to_linear_rgb
    from ..vardct.frame import (VarDCTState, adaptive_dc_smoothing,
                                decode_cmap_dc, decode_dc_group,
                                read_block_ctx_map)
    from ..api.frame import (ModularFrameState, decode_global_info,
                             decode_modular_group, modular_dc_stream_id,
                             num_toc_entries)
    from ..io.frame_header import (FLAG_NOISE, FLAG_PATCHES,
                                   FLAG_SPLINES,
                                   FLAG_SKIP_ADAPTIVE_DC_SMOOTHING,
                                   FLAG_USE_DC_FRAME)

    if is_container(data):
        data = extract_codestream(data)
    r = BitReader(data)
    meta = parse_codestream_header(r)
    if not meta.m.xyb_encoded:
        raise JXLError("dc decode: non-XYB stream")
    if meta.m.have_preview:
        _skip_or_decode_preview(r, meta)
    fh = FrameHeader(meta)
    fh.read(r)
    if fh.frame_type != FT_REGULAR or not fh.is_last \
            or fh.encoding == _MOD:
        raise JXLError("dc decode: unsupported stream shape")
    if fh.flags & FLAG_USE_DC_FRAME:
        raise JXLError("dc decode: kUseDcFrame stream")
    fd = fh.frame_dimensions()
    state = VarDCTState(fh, fd, alloc_xyb=False)
    mstate = ModularFrameState()
    n = num_toc_entries(fd, fh.passes.num_passes)
    offsets, sizes, total = read_group_offsets(n, r)
    r.jump_to_byte_boundary()
    base = r.total_bits_consumed() // 8
    raw = r.data

    def section_reader(idx):
        start = base + offsets[idx]
        return BitReader(raw[start:start + sizes[idx]])

    def dc_global(sr):
        if fh.flags & FLAG_PATCHES:
            raise JXLError("dc decode: patches")
        if fh.flags & FLAG_SPLINES:
            from ..render.splines import decode_splines

            decode_splines(sr, fd.xsize * fd.ysize)
        if fh.flags & FLAG_NOISE:
            from ..render.noise import decode_noise

            decode_noise(sr)
        state.matrices.decode_dc(sr)
        state.quantizer.decode(sr)
        read_block_ctx_map(sr, state)
        decode_cmap_dc(sr, state)
        decode_global_info(sr, fh, fd, mstate)
        state.tree = mstate.tree
        state.code = mstate.code
        state.context_map = mstate.context_map

    def dc_group(g, sr):
        decode_dc_group(sr, state, g)
        gx = g % fd.xsize_dc_groups
        gy = g // fd.xsize_dc_groups
        rect = (gx * fd.dc_group_dim, gy * fd.dc_group_dim,
                fd.dc_group_dim, fd.dc_group_dim)
        decode_modular_group(sr, fh, fd, mstate, rect, 3, 1000,
                             modular_dc_stream_id(fd, g))

    if fd.num_groups == 1 and fh.passes.num_passes == 1:
        sr = section_reader(0)
        dc_global(sr)
        dc_group(0, sr)
    else:
        dc_global(section_reader(0))
        for g in range(fd.num_dc_groups):
            dc_group(g, section_reader(1 + g))
    if not (fh.flags & FLAG_SKIP_ADAPTIVE_DC_SMOOTHING):
        fac = [state.quantizer.mul_dc(c) for c in range(3)]
        state.dc = adaptive_dc_smoothing(state.dc, fac)
    ny = -(-fd.ysize // 8)
    nx = -(-fd.xsize // 8)
    xyb_dc = np.asarray(state.dc[:, :ny, :nx], dtype=np.float64)
    rgb = np.clip(xyb_to_linear_rgb(xyb_dc), 0.0, 1.0)
    return linear_to_srgb_u8(np.moveaxis(rgb, 0, -1)), meta


def decode_rows(data: bytes, num_threads: int = 0, device="cuda"):
    """Bounded-memory decode: generator of (y0, uint8 rows (h, W, 3)).

    The low-memory group-at-a-time scheduler
    (vardct/low_memory.py; reference low_memory_render_pipeline.cc):
    peak pixel memory is three AC-group rows plus the 1/64-area DC
    fields (plus any extra-channel planes at 1-2 B/px), never the full
    float image. Supported strip-wise: progressive passes, 2-8x
    upsampling (exact seam context), subsampled YCbCr, 16-bit integer
    output, alpha/extra channels, splines and patch dictionaries
    (clipped per-strip blends; the small patch sheets decode
    whole-image first). JXLError is raised for animation blending,
    alpha-blend patches, modular-mode frames, float/deep samples and
    CMS output — fall back to decode().

    device: a torch device, "cuda" by default (a missing card raises),
    renders each strip of an 8-bit stream inside the device scope there
    (vardct/low_memory.py: dequant_idct8 and render_tail once a strip,
    sRGB u8 rows back); "cpu" runs the same render on the plain twins;
    None renders every strip on the host. Streams outside the scope take
    the host strips.
    """
    from ..io.frame_header import ENC_MODULAR as _MOD, FT_REGULAR
    from ..ops.xyb import linear_to_srgb, xyb_to_linear_rgb
    from ..vardct.low_memory import decode_vardct_strips

    if device is not None:
        from ..base.device import resolve_device

        device = resolve_device(device)
    r = BitReader(data)
    meta = parse_codestream_header(r)
    bits = meta.m.bit_depth.bits_per_sample
    if meta.m.bit_depth.floating_point_sample or bits > 16:
        raise JXLError("low-memory decode: float/deep sample output")
    if meta.m.orientation != 1:
        raise JXLError("low-memory decode: orientation")
    if meta.m.have_preview:
        raise JXLError("low-memory decode: preview frame")
    # non-XYB streams are fine when YCbCr (JPEG-transcode family):
    # strips come back as YCbCr planes and convert below
    if meta.m.color_encoding.want_icc:
        raise JXLError("low-memory decode: CMS output stage")
    from ..io.frame_header import FT_REFERENCE_ONLY as _FT_REF_LM

    reference_frames = [None] * 4
    reference_extra = [None] * 4
    while True:
        fh = FrameHeader(meta)
        fh.read(r)
        if fh.frame_type == _FT_REF_LM:
            # patch sheets are small by construction; decode them
            # whole-image and stash, then strip the main frame
            _stash_reference_frame(r, fh, meta, reference_frames,
                                   reference_extra)
            r.jump_to_byte_boundary()
            continue
        break
    if fh.frame_type != FT_REGULAR or not fh.is_last:
        raise JXLError("low-memory decode: multi-frame stream")
    if fh.encoding == _MOD:
        raise JXLError("low-memory decode: modular frame")
    from ..io.frame_header import CT_YCBCR as _CT_YCBCR_LM

    ycbcr = fh.color_transform == _CT_YCBCR_LM
    if not meta.m.xyb_encoded and not ycbcr:
        raise JXLError("low-memory decode: non-XYB/non-YCbCr stream")
    maxval = (1 << min(bits, 16)) - 1
    odt = np.uint8 if bits <= 8 else np.uint16

    def with_ec(rows_px, ec):
        if not ec:
            return rows_px
        ecs = np.stack([np.clip(np.round(e), 0, maxval).astype(odt)
                        for e in ec], axis=-1)
        return np.concatenate([rows_px, ecs], axis=-1)

    for item in decode_vardct_strips(
            r, fh, num_threads, device=device if bits <= 8 else None,
            reference_frames=reference_frames,
            reference_extra=reference_extra):
        y0, strip = item[0], item[1]
        ec = item[2] if len(item) > 2 else None
        if strip.dtype == np.uint8:
            # device-rendered strip: already final sRGB u8 rows
            yield y0, strip
            continue
        if ycbcr:
            from ..vardct.frame import ycbcr_to_rgb

            rgb = ycbcr_to_rgb(strip)
            yield y0, with_ec(np.clip(
                np.round(np.moveaxis(rgb, 0, -1) * maxval), 0,
                maxval).astype(odt), ec)
            continue
        rgb = xyb_to_linear_rgb(strip)
        if bits <= 8:
            from ..ops.xyb import linear_to_srgb_u8

            yield y0, with_ec(linear_to_srgb_u8(
                np.moveaxis(rgb, 0, -1)), ec)
        else:
            # HDR leg: 9-16 bit sRGB-transfer samples per row
            srgb = linear_to_srgb(
                np.clip(np.moveaxis(rgb, 0, -1), 0.0, 1.0))
            yield y0, with_ec(np.clip(np.round(srgb * maxval), 0,
                                      maxval).astype(np.uint16), ec)


def decode_preview(data: bytes):
    """Decode only the preview frame; returns (image, meta) or
    (None, meta) when the stream has no preview."""
    r = BitReader(data)
    meta = parse_codestream_header(r)
    if not meta.m.have_preview:
        return None, meta
    return _skip_or_decode_preview(r, meta, want=True), meta


def encode_with_patches(image: np.ndarray, patch_sheet: np.ndarray,
                        placements, distance: float = 1.0,
                        sheet_distance: float = None,
                        blend_mode: int = None, device="cuda") -> bytes:
    """Encode with a patch dictionary (kPatches image feature).

    patch_sheet: (Hs, Ws, 3|4) uint8 image holding the patch contents; it
    is coded as a kReferenceOnly frame, roundtripped (like the reference's
    RoundtripPatchFrame, enc_patch_dictionary.cc) so the encoder subtracts
    exactly what the decoder will add.
    placements: list of (sheet_x0, sheet_y0, w, h, [(x, y), ...]) — each
    rect of the sheet is blitted at the given positions.
    For kAdd (default), `image` is the intended final image (patch content
    included). With a 4-channel sheet (or blend_mode kBlendAbove), the
    sheet is alpha-composited over `image` at decode time
    (PerformAlphaBlending, blending.cc:50-76): `image` is the background.
    device: where both frames' AC-strategy tile costs run, as in
    encode_lossy ("cuda" by default, raising without a card; "cpu"; None
    on the host).
    """
    from ..io.frame_header import (
        CT_XYB,
        ENC_VARDCT,
        FLAG_SKIP_ADAPTIVE_DC_SMOOTHING,
        FT_REFERENCE_ONLY,
        FT_REGULAR,
        FrameHeader,
    )
    from ..ops.xyb import srgb_to_linear, srgb_u8_to_linear
    from ..render.patches import (
        BLEND_ADD,
        BLEND_BLEND_ABOVE,
        PatchBlending,
        PatchPosition,
        PatchReferencePosition,
        PatchesState,
    )
    from ..vardct.frame import decode_vardct_frame, encode_vardct_frame

    if device is not None:
        from ..base.device import resolve_device

        device = resolve_device(device)
    sheet_alpha = None
    if patch_sheet.ndim == 3 and patch_sheet.shape[2] == 4:
        sheet_alpha = patch_sheet[:, :, 3].astype(np.int32)
        patch_sheet = patch_sheet[:, :, :3]
        if blend_mode is None:
            blend_mode = BLEND_BLEND_ABOVE
    if blend_mode is None:
        blend_mode = BLEND_ADD
    if blend_mode == BLEND_BLEND_ABOVE and sheet_alpha is None:
        sheet_alpha = np.full(patch_sheet.shape[:2], 255, dtype=np.int32)
    h, w, _ = image.shape
    sh, sw, _ = patch_sheet.shape
    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    num_extra = 0
    if sheet_alpha is not None:
        meta.m.all_default = False
        meta.m.set_alpha_bits(8)
        num_extra = 1
    writer = BitWriter()
    write_codestream_header(writer, meta)

    # --- reference-only patch frame, roundtripped
    def make_ref_header():
        fh = FrameHeader(meta)
        fh.all_default = False
        fh.frame_type = FT_REFERENCE_ONLY
        fh.encoding = ENC_VARDCT
        fh.color_transform = CT_XYB
        fh.flags = FLAG_SKIP_ADAPTIVE_DC_SMOOTHING
        fh.loop_filter.all_default = False
        fh.loop_filter.gab = False
        fh.loop_filter.epf_iters = 0
        if (sw, sh) != (w, h):
            fh.custom_size_or_origin = True
            fh.frame_xsize = sw
            fh.frame_ysize = sh
        fh.save_as_reference = 0
        fh.save_before_color_transform = True
        return fh

    sheet_rgb = np.moveaxis(
        srgb_to_linear(patch_sheet.astype(np.float64) / 255.0), -1, 0)
    tmp = BitWriter()
    encode_vardct_frame(tmp, sheet_rgb, make_ref_header(),
                        distance=sheet_distance or min(distance, 1.0),
                        extra_channels=[sheet_alpha]
                        if sheet_alpha is not None else None, device=device)
    ref_bytes = tmp.get_bytes()
    rr = BitReader(ref_bytes)
    fh2 = FrameHeader(meta)
    fh2.read(rr)
    ref_ec = []
    xyb_sheet = decode_vardct_frame(rr, fh2, return_xyb=True,
                                    extra_out=ref_ec)
    writer.append_bytes(ref_bytes)

    # --- patch dictionary
    st = PatchesState()
    st.blendings_stride = 1 + num_extra
    for (sx, sy, pw, ph, poses) in placements:
        rp_idx = len(st.ref_positions)
        st.ref_positions.append(PatchReferencePosition(0, sx, sy, pw, ph))
        for (x, y) in poses:
            st.positions.append(PatchPosition(x, y, rp_idx))
            st.blendings.append([PatchBlending(blend_mode)
                                 for _ in range(1 + num_extra)])

    # --- main frame
    fh = FrameHeader(meta)
    fh.all_default = False
    fh.frame_type = FT_REGULAR
    fh.encoding = ENC_VARDCT
    fh.color_transform = CT_XYB
    fh.flags = 0  # adaptive DC smoothing on (see encode_lossy)
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = True
    fh.loop_filter.epf_iters = 2
    rgb = np.moveaxis((srgb_u8_to_linear(image) if image.dtype == np.uint8
           else srgb_to_linear(image.astype(np.float64) / 255.0)), -1, 0)
    main_extra = None
    if num_extra:
        # background is fully opaque unless the caller's image has alpha
        main_extra = [np.full((h, w), 255, dtype=np.int32)]
    encode_vardct_frame(writer, rgb, fh, distance=distance, patches=st,
                        reference_frames=[xyb_sheet, None, None, None],
                        extra_channels=main_extra, device=device)
    return writer.get_bytes()


# ------------------------------------------------------------------ animation
def encode_animation(frames, fps_numerator: int = 10, fps_denominator: int = 1,
                     num_loops: int = 0, lossless: bool = True,
                     distance: float = 1.0, durations=None,
                     device="cuda") -> bytes:
    """Encode a list of (H, W, C) uint8 frames as an animated codestream.

    Each frame is a kReplace full frame; durations (optional per-frame
    tick counts, default 1) are in 1/(fps_numerator/fps_denominator)
    seconds (frame_header.cc AnimationFrame). device: where each lossy
    frame's AC-strategy tile costs run, as in encode_lossy ("cuda" by
    default, raising without a card; "cpu"; None on the host); a
    lossless animation never uses it."""
    from ..io.frame_header import (
        CT_NONE,
        CT_XYB,
        ENC_MODULAR,
        ENC_VARDCT,
        FLAG_SKIP_ADAPTIVE_DC_SMOOTHING,
        FT_REGULAR,
        FrameHeader,
    )
    from ..ops.xyb import srgb_to_linear, srgb_u8_to_linear
    from ..vardct.frame import encode_vardct_frame

    if device is not None and not lossless:
        from ..base.device import resolve_device

        device = resolve_device(device)
    else:
        device = None
    first = frames[0]
    if first.ndim == 2:
        frames = [f[:, :, None] for f in frames]
        first = frames[0]
    h, w, nc = first.shape
    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    meta.m.all_default = False
    meta.m.have_animation = True
    meta.m.animation.tps_numerator = fps_numerator
    meta.m.animation.tps_denominator = fps_denominator
    meta.m.animation.num_loops = num_loops
    if lossless:
        meta.m.xyb_encoded = False
    writer = BitWriter()
    write_codestream_header(writer, meta)
    for i, frame in enumerate(frames):
        last = i == len(frames) - 1
        dur = int(durations[i]) if durations is not None else 1
        if lossless:
            fh = make_modular_frame_header(meta, is_last=last)
            fh.animation_frame.nonserialized_metadata = meta
            fh.animation_frame.duration = dur
            channels = [frame[:, :, c].astype(np.int32)
                        for c in range(frame.shape[2])]
            opts = ModularEncOptions(
                color_transform=6 if frame.shape[2] >= 3 else None)
            encode_modular_frame(writer, channels, fh, opts)
        else:
            fh = FrameHeader(meta)
            fh.all_default = False
            fh.frame_type = FT_REGULAR
            fh.encoding = ENC_VARDCT
            fh.color_transform = CT_XYB
            fh.flags = 0  # adaptive DC smoothing on (see encode_lossy)
            fh.is_last = last
            fh.animation_frame.nonserialized_metadata = meta
            fh.animation_frame.duration = dur
            fh.loop_filter.all_default = False
            fh.loop_filter.gab = True
            fh.loop_filter.epf_iters = 2
            rgb = np.moveaxis(srgb_to_linear(frame.astype(np.float64) / 255.0),
                              -1, 0)
            encode_vardct_frame(writer, rgb, fh, distance=distance,
                                device=device)
        writer.zero_pad_to_byte()
    return writer.get_bytes()


def decode_frames(data: bytes, device="cuda"):
    """Generator yielding (image, duration_ticks) for every frame.

    device: a torch device ("cuda" by default; a missing card raises)
    renders each VarDCT frame's pixel pipeline there (the render of
    decode()); None renders on the host."""
    from ..ops.xyb import linear_to_srgb
    from ..vardct.frame import decode_vardct_frame

    if device is not None:
        from ..base.device import resolve_device

        device = resolve_device(device)
    r = BitReader(data)
    meta = parse_codestream_header(r)
    bits = meta.m.bit_depth.bits_per_sample
    while True:
        fh = FrameHeader(meta)
        fh.read(r)
        if fh.encoding == ENC_MODULAR:
            img = decode_modular_frame(r, fh)
            stacked = np.stack([c.data for c in img.channel], axis=-1)
            if bits <= 8:
                stacked = stacked.astype(np.uint8)
            elif bits <= 16:
                stacked = stacked.astype(np.uint16)
        else:
            render_fn = None
            out = {}
            if device is not None:
                from .tpu_codec import make_device_render

                out["want_u8"] = (bits <= 8 and meta.m.orientation == 1
                                  and meta.m.xyb_encoded)
                render_fn = make_device_render(fh, out, device)
            chans = decode_vardct_frame(r, fh, render_fn=render_fn,
                                        want_qimg=device is not None)
            if chans is None and "u8" in out:
                stacked = out["u8"]
            elif bits <= 8:
                from ..ops.xyb import linear_to_srgb_u8

                stacked = linear_to_srgb_u8(np.stack(chans, axis=-1))
            else:
                stacked = linear_to_srgb(np.stack(chans, axis=-1))
        r.jump_to_byte_boundary()
        yield stacked, fh.animation_frame.duration
        if fh.is_last:
            return
