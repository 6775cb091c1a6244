"""ICC profile analysis: classify a profile as a known enum color
encoding (lib/extras/dec/color_description.cc + icc_simplify.cc
behavior: replace a byte-blob profile by its enum description when one
matches).

Parses the ICC header + tag table (wtpt/rXYZ/gXYZ/bXYZ, curv/para TRC,
cicp) and matches against the JPEG XL enum spaces: sRGB, linear sRGB,
Display P3, Rec.2020 (SDR/PQ/HLG), gamma profiles.
"""

from __future__ import annotations

import struct

import numpy as np

from ..base.status import JXLError

_D65 = (0.3127, 0.3290)
_D50_XYZ = (0.9642, 1.0, 0.8249)

# xy chromaticities of known primary sets (color_encoding.cc)
_PRIMARIES = {
    "srgb": ((0.640, 0.330), (0.300, 0.600), (0.150, 0.060)),
    "p3": ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060)),
    "rec2020": ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046)),
}


def _read_tag_table(icc: bytes):
    if len(icc) < 132:
        raise JXLError("ICC: truncated")
    count = struct.unpack(">I", icc[128:132])[0]
    if count > 1000 or len(icc) < 132 + 12 * count:
        raise JXLError("ICC: bad tag table")
    tags = {}
    for i in range(count):
        sig, off, size = struct.unpack(
            ">4sII", icc[132 + 12 * i:144 + 12 * i])
        if off + size <= len(icc):
            tags[sig.decode("latin1")] = icc[off:off + size]
    return tags


def _xyz(tag: bytes):
    if len(tag) < 20 or tag[:4] != b"XYZ ":
        return None
    x, y, z = struct.unpack(">iii", tag[8:20])
    return (x / 65536.0, y / 65536.0, z / 65536.0)


def _xyz_to_xy(xyz):
    s = sum(xyz)
    if s <= 0:
        return (0.0, 0.0)
    return (xyz[0] / s, xyz[1] / s)


def _trc_kind(tag: bytes):
    """Returns ('gamma', g) / ('srgb', None) / ('linear', None) /
    ('table', None)."""
    if tag is None or len(tag) < 12:
        return ("unknown", None)
    if tag[:4] == b"curv":
        n = struct.unpack(">I", tag[8:12])[0]
        if n == 0:
            return ("linear", None)
        if n == 1:
            if len(tag) < 14:
                return ("unknown", None)
            g = struct.unpack(">H", tag[12:14])[0] / 256.0
            return (("linear", None) if abs(g - 1.0) < 1e-3
                    else ("gamma", g))
        return ("table", None)
    if tag[:4] == b"para":
        fn = struct.unpack(">H", tag[8:10])[0]
        params = [struct.unpack(">i", tag[12 + 4 * i:16 + 4 * i])[0]
                  / 65536.0
                  for i in range((len(tag) - 12) // 4)]
        if fn == 0 and params:
            g = params[0]
            return (("linear", None) if abs(g - 1.0) < 1e-3
                    else ("gamma", g))
        if fn in (3, 4) and len(params) >= 5:
            # sRGB-style piecewise: g, a, b, c, d
            g, a, b, c, d = params[:5]
            if (abs(g - 2.4) < 0.02 and abs(a - 1 / 1.055) < 0.01
                    and abs(d - 0.04045) < 0.005):
                return ("srgb", None)
            return ("gamma", g)
    return ("unknown", None)


def _match_primaries(r_xy, g_xy, b_xy, tol=0.02):
    for name, (pr, pg, pb) in _PRIMARIES.items():
        if (abs(r_xy[0] - pr[0]) < tol and abs(r_xy[1] - pr[1]) < tol
                and abs(g_xy[0] - pg[0]) < tol
                and abs(g_xy[1] - pg[1]) < tol
                and abs(b_xy[0] - pb[0]) < tol
                and abs(b_xy[1] - pb[1]) < tol):
            return name
    return None


def analyze_icc(icc: bytes) -> dict:
    """Returns {color_space, white_point, primaries, transfer,
    gamma, description} — description in the reference's
    color_description format (e.g. 'RGB_D65_SRG_Rel_SRG')."""
    if len(icc) < 132:
        raise JXLError("ICC: too small")
    space = icc[16:20].decode("latin1").strip()
    tags = _read_tag_table(icc)
    out = {"color_space": "Gray" if space == "GRAY" else "RGB"}
    # cicp (ITU-T H.273) wins if present
    cicp = tags.get("cicp")
    if cicp is not None and len(cicp) >= 12:
        prim, trc, _mtx, _full = cicp[8], cicp[9], cicp[10], cicp[11]
        prim_name = {1: "srgb", 12: "p3", 9: "rec2020"}.get(prim)
        trc_name = {1: "709", 8: "Lin", 13: "SRG", 16: "PQ",
                    18: "HLG"}.get(trc, "?")
        out.update(primaries=prim_name, transfer=trc_name,
                   white_point="D65", gamma=None)
        return _describe(out)
    # colorant tags are stored adapted to the D50 PCS; undo the 'chad'
    # chromatic adaptation to recover the actual primaries/white point
    chad_inv = None
    chad = tags.get("chad")
    if chad is not None and len(chad) >= 44 and chad[:4] == b"sf32":
        vals = [struct.unpack(">i", chad[8 + 4 * i:12 + 4 * i])[0]
                / 65536.0 for i in range(9)]
        try:
            chad_inv = np.linalg.inv(np.array(vals).reshape(3, 3))
        except np.linalg.LinAlgError:
            chad_inv = None

    def unadapt(xyz):
        if xyz is None:
            return None
        if chad_inv is None:
            return xyz
        return tuple(chad_inv @ np.asarray(xyz))

    rx = unadapt(_xyz(tags.get("rXYZ", b"")))
    gx = unadapt(_xyz(tags.get("gXYZ", b"")))
    bx = unadapt(_xyz(tags.get("bXYZ", b"")))
    if rx is not None and gx is not None and bx is not None:
        tol = 0.02 if chad_inv is not None else 0.06
        out["primaries"] = _match_primaries(
            _xyz_to_xy(rx), _xyz_to_xy(gx), _xyz_to_xy(bx), tol=tol)
    else:
        out["primaries"] = None
    kind, g = _trc_kind(tags.get("rTRC") or tags.get("kTRC"))
    out["transfer"] = {"srgb": "SRG", "linear": "Lin",
                       "gamma": "gamma", "table": "table",
                       "unknown": "?"}[kind]
    out["gamma"] = g
    out["white_point"] = "D65"
    wt = _xyz(tags.get("wtpt", b""))
    if wt:
        # with a chad tag, wtpt is the PCS illuminant (D50) and the
        # real white is chad^-1 @ wtpt; without one, wtpt is the white
        xy = _xyz_to_xy(unadapt(wt) if chad_inv is not None else wt)
        if abs(xy[0] - 0.3457) < 0.01 and abs(xy[1] - 0.3585) < 0.01:
            out["white_point"] = "D50"
    return _describe(out)


def _describe(out: dict) -> dict:
    prim_code = {"srgb": "SRG", "p3": "DCI", "rec2020": "202",
                 None: "???"}[out.get("primaries")]
    tf = out.get("transfer")
    if tf == "gamma" and out.get("gamma"):
        tf_code = f"g{out['gamma']:.3g}"
    else:
        tf_code = {"SRG": "SRG", "Lin": "Lin", "PQ": "PQ", "HLG": "HLG",
                   "709": "709", "table": "???", "?": "???"}.get(
                       tf, "???")
    if out["color_space"] == "Gray":
        out["description"] = f"Gra_{out['white_point']}_Rel_{tf_code}"
    else:
        out["description"] = (f"RGB_{out['white_point']}_{prim_code}"
                              f"_Rel_{tf_code}")
    return out
