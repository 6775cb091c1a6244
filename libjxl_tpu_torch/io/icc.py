"""Compressed ICC profile codec.

JPEG XL stores ICC profiles in a transformed, entropy-coded form: the
profile bytes are rewritten as a (commands, data) pair exploiting ICC
structure (header prediction, tag-list modeling, shuffled/linearly
predicted curve data), then the transformed bytes are rANS-coded with 41
contexts keyed on the two previous bytes.

Reference behavior mirrored here (independent re-implementation):
  - icc_codec_common.cc:17-47 (byte-kind context classes, PredictValue)
  - icc_codec_common.cc:94-175 (header prediction, LinearPredictICCValue,
    ICCANSContext)
  - icc_codec.cc:97-321 (UnpredictICC), icc_codec.cc:325-413 (ICCReader)
  - enc_icc_codec.cc:36-445 (Unshuffle, PredictICC, WriteICC)
  - icc_codec_common.h:21-89 (tag/type string tables, command codes)
"""

from __future__ import annotations

from ..base.status import JXLError
from .bits import BitReader, BitWriter
from .fields import u64_read, u64_write

ICC_HEADER_SIZE = 128
NUM_ICC_CONTEXTS = 41

# Tag names focused on RGB and GRAY monitor profiles (icc_codec_common.h:56)
TAG_STRINGS = [b"cprt", b"wtpt", b"bkpt", b"rXYZ", b"gXYZ", b"bXYZ",
               b"kXYZ", b"rTRC", b"gTRC", b"bTRC", b"kTRC", b"chad",
               b"desc", b"chrm", b"dmnd", b"dmdd", b"lumi"]
# Tag types (icc_codec_common.h:69)
TYPE_STRINGS = [b"XYZ ", b"desc", b"text", b"mluc",
                b"para", b"curv", b"sf32", b"gbd "]

CMD_TAG_UNKNOWN = 1
CMD_TAG_TRC = 2
CMD_TAG_XYZ = 3
CMD_TAG_STRING_FIRST = 4
CMD_INSERT = 1
CMD_SHUFFLE2 = 2
CMD_SHUFFLE4 = 3
CMD_PREDICT = 4
CMD_XYZ = 10
CMD_TYPE_START_FIRST = 16
FLAG_BIT_OFFSET = 64
FLAG_BIT_SIZE = 128

SIZE_LIMIT = (1 << 32) - 1 >> 2

# Fixed-size tags whose size is predicted as 20 bytes
_SIZE20_TAGS = {b"rXYZ", b"gXYZ", b"bXYZ", b"kXYZ", b"wtpt", b"bkpt", b"lumi"}

_INITIAL_HEADER = bytes([
    0, 0, 0, 0, 0, 0, 0, 0, 4, 0, 0, 0]) + b"mntrRGB XYZ " + bytes(12) + \
    b"acsp" + bytes(28) + bytes([0, 0, 246, 214, 0, 1, 0, 0, 0, 0, 211, 45]) \
    + bytes(48)
assert len(_INITIAL_HEADER) == ICC_HEADER_SIZE


def _byte_kind1(b: int) -> int:
    if 97 <= b <= 122 or 65 <= b <= 90:
        return 0
    if 48 <= b <= 57 or b in (0x2E, 0x2C):
        return 1
    if b == 0:
        return 2
    if b == 1:
        return 3
    if b < 16:
        return 4
    if b == 255:
        return 6
    if b > 240:
        return 5
    return 7


def _byte_kind2(b: int) -> int:
    if 97 <= b <= 122 or 65 <= b <= 90:
        return 0
    if 48 <= b <= 57 or b in (0x2E, 0x2C):
        return 1
    if b < 16:
        return 2
    if b > 240:
        return 3
    return 4


def icc_context(i: int, b1: int, b2: int) -> int:
    """ANS context for byte i given the two previous bytes."""
    if i <= 128:
        return 0
    return 1 + _byte_kind1(b1) + _byte_kind2(b2) * 8


def _predict_value(p1: int, p2: int, p3: int, order: int) -> int:
    if order == 0:
        return p1
    if order == 1:
        return 2 * p1 - p2
    if order == 2:
        return 3 * p1 - 3 * p2 + p3
    return 0


def _decode_u32be(data: bytes, pos: int) -> int:
    if pos + 4 > len(data):
        return 0
    return int.from_bytes(data[pos:pos + 4], "big")


def _initial_header_prediction(size: int) -> bytearray:
    h = bytearray(_INITIAL_HEADER)
    h[0:4] = (size & 0xFFFFFFFF).to_bytes(4, "big")
    return h


def _predict_header(icc: bytes, size: int, header: bytearray,
                    pos: int) -> None:
    if pos == 8 and size >= 8:
        header[80:84] = icc[4:8]
    if pos == 41 and size >= 41:
        if icc[40] == ord("A"):
            header[41:44] = b"PPL"
        if icc[40] == ord("M"):
            header[41:44] = b"SFT"
    if pos == 42 and size >= 42:
        if icc[40:42] == b"SG":
            header[42:44] = b"I "
        if icc[40:42] == b"SU":
            header[42:44] = b"NW"


def _linear_predict(data, start: int, i: int, stride: int, width: int,
                    order: int) -> int:
    """Byte of the linear prediction at start+i; multi-byte values are
    big-endian with `width` bytes and `stride` spacing."""
    pos = start + i
    if width == 1:
        pred = _predict_value(data[pos - stride], data[pos - stride * 2],
                              data[pos - stride * 3], order)
        return pred & 255
    if width == 2:
        p = start + (i & ~1)
        ps = [(data[p - stride * k] << 8) + data[p - stride * k + 1]
              for k in (1, 2, 3)]
        pred = _predict_value(*ps, order) & 0xFFFF
        return pred & 255 if (i & 1) else (pred >> 8) & 255
    p = start + (i & ~3)

    def u32(q):  # DecodeUint32 with size = pos (icc_codec_common.cc:49-51)
        if q + 4 > pos:
            return 0
        return (data[q] << 24) | (data[q + 1] << 16) | (data[q + 2] << 8) \
            | data[q + 3]

    pred = _predict_value(u32(p - stride), u32(p - stride * 2),
                          u32(p - stride * 3), order) & 0xFFFFFFFF
    return (pred >> ((3 - (i & 3)) * 8)) & 255


def _shuffle(data: bytearray, width: int) -> bytearray:
    """Interleave: with width 2 turns "ABCDabcd" into "AaBbCcDd"
    (icc_codec.cc:31-50)."""
    size = len(data)
    height = (size + width - 1) // width
    out = bytearray(size)
    s = 0
    j = 0
    for i in range(size):
        out[i] = data[j]
        j += height
        if j >= size:
            s += 1
            j = s
    return out


def _unshuffle(data: bytearray, width: int) -> bytearray:
    """De-interleave: inverse of _shuffle (enc_icc_codec.cc:36-55)."""
    size = len(data)
    height = (size + width - 1) // width
    out = bytearray(size)
    s = 0
    j = 0
    for i in range(size):
        out[j] = data[i]
        j += height
        if j >= size:
            s += 1
            j = s
    return out


def _decode_varint(enc, size: int, pos: int):
    ret = 0
    i = 0
    while pos + i < size and i < 10:
        ret |= (enc[pos + i] & 127) << (7 * i)
        if (enc[pos + i] & 128) == 0:
            break
        i += 1
    return ret, pos + i + 1


def _encode_varint(value: int, out: bytearray) -> None:
    while value > 127:
        out.append((value & 127) | 128)
        value >>= 7
    out.append(value & 127)


def unpredict_icc(enc: bytes, output_limit: int = None) -> bytes:
    """Inverse of predict_icc: reconstruct the ICC profile
    (icc_codec.cc:97-321). output_limit bounds the DECODED size (the
    command stream can amplify ~36x, so the encoded-size check alone
    permits a memory-exhaustion profile)."""
    size = len(enc)
    pos = 0
    if pos >= size:
        raise JXLError("ICC: out of bounds")
    osize, pos = _decode_varint(enc, size, pos)
    if osize > SIZE_LIMIT or (output_limit is not None
                              and osize > output_limit):
        raise JXLError("ICC: output too large")
    if pos >= size:
        raise JXLError("ICC: out of bounds")
    csize, pos = _decode_varint(enc, size, pos)
    cpos = pos
    commands_end = cpos + csize
    if commands_end > size:
        raise JXLError("ICC: out of bounds")
    pos = commands_end  # data stream position

    result = bytearray()

    def check_done():
        if len(result) == osize:
            if cpos != commands_end:
                raise JXLError("ICC: not all commands used")
            if pos != size:
                raise JXLError("ICC: not all data used")
            return True
        return False

    # Header
    header = _initial_header_prediction(osize)
    for i in range(ICC_HEADER_SIZE + 1):
        if check_done():
            return bytes(result)
        if i == ICC_HEADER_SIZE:
            break
        _predict_header(bytes(result), len(result), header, i)
        if pos >= size:
            raise JXLError("ICC: out of bounds")
        result.append((enc[pos] + header[i]) & 255)
        pos += 1
    if cpos >= commands_end:
        raise JXLError("ICC: out of bounds")

    # Tag list
    numtags, cpos = _decode_varint(enc, size, cpos)
    if numtags != 0:
        numtags -= 1
        if numtags > 0xFFFFFFFF:
            raise JXLError("ICC: numtags not 32-bit")
        result += numtags.to_bytes(4, "big")
        prevtagstart = ICC_HEADER_SIZE + numtags * 12
        prevtagsize = 0
        while True:
            if len(result) > osize:
                raise JXLError("ICC: invalid result size")
            if cpos > commands_end:
                raise JXLError("ICC: out of bounds")
            if cpos == commands_end:
                break
            command = enc[cpos]
            cpos += 1
            tagcode = command & 63
            if tagcode == 0:
                break
            elif tagcode == CMD_TAG_UNKNOWN:
                if pos + 4 > size:
                    raise JXLError("ICC: out of bounds")
                tag = bytes(enc[pos:pos + 4])
                pos += 4
            elif tagcode == CMD_TAG_TRC:
                tag = b"rTRC"
            elif tagcode == CMD_TAG_XYZ:
                tag = b"rXYZ"
            else:
                idx = tagcode - CMD_TAG_STRING_FIRST
                if idx >= len(TAG_STRINGS):
                    raise JXLError("ICC: unknown tagcode")
                tag = TAG_STRINGS[idx]
            result += tag
            tagsize = 20 if tag in _SIZE20_TAGS else prevtagsize
            if command & FLAG_BIT_OFFSET:
                if cpos >= commands_end:
                    raise JXLError("ICC: out of bounds")
                tagstart, cpos = _decode_varint(enc, size, cpos)
            else:
                tagstart = prevtagstart + prevtagsize
            if tagstart > 0xFFFFFFFF:
                raise JXLError("ICC: tagstart not 32-bit")
            result += tagstart.to_bytes(4, "big")
            if command & FLAG_BIT_SIZE:
                if cpos >= commands_end:
                    raise JXLError("ICC: out of bounds")
                tagsize, cpos = _decode_varint(enc, size, cpos)
            if tagsize > 0xFFFFFFFF:
                raise JXLError("ICC: tagsize not 32-bit")
            result += tagsize.to_bytes(4, "big")
            prevtagstart, prevtagsize = tagstart, tagsize
            if tagcode == CMD_TAG_TRC:
                for t in (b"gTRC", b"bTRC"):
                    result += t + tagstart.to_bytes(4, "big") \
                        + tagsize.to_bytes(4, "big")
            if tagcode == CMD_TAG_XYZ:
                if tagstart + tagsize * 2 > 0xFFFFFFFF:
                    raise JXLError("ICC: offset not 32-bit")
                result += b"gXYZ" + (tagstart + tagsize).to_bytes(4, "big") \
                    + tagsize.to_bytes(4, "big")
                result += b"bXYZ" + (tagstart + 2 * tagsize).to_bytes(4, "big")\
                    + tagsize.to_bytes(4, "big")

    # Main content
    while True:
        if len(result) > osize:
            raise JXLError("ICC: invalid result size")
        if cpos > commands_end:
            raise JXLError("ICC: out of bounds")
        if cpos == commands_end:
            break
        command = enc[cpos]
        cpos += 1
        if command == CMD_INSERT:
            if cpos >= commands_end:
                raise JXLError("ICC: out of bounds")
            num, cpos = _decode_varint(enc, size, cpos)
            if pos + num > size:
                raise JXLError("ICC: out of bounds")
            result += enc[pos:pos + num]
            pos += num
        elif command in (CMD_SHUFFLE2, CMD_SHUFFLE4):
            if cpos >= commands_end:
                raise JXLError("ICC: out of bounds")
            num, cpos = _decode_varint(enc, size, cpos)
            if pos + num > size:
                raise JXLError("ICC: out of bounds")
            shuffled = _shuffle(bytearray(enc[pos:pos + num]),
                                2 if command == CMD_SHUFFLE2 else 4)
            result += shuffled
            pos += num
        elif command == CMD_PREDICT:
            if cpos + 2 > commands_end:
                raise JXLError("ICC: out of bounds")
            flags = enc[cpos]
            cpos += 1
            width = (flags & 3) + 1
            if width == 3:
                raise JXLError("ICC: invalid width")
            order = (flags & 12) >> 2
            if order == 3:
                raise JXLError("ICC: invalid order")
            stride = width
            if flags & 16:
                if cpos >= commands_end:
                    raise JXLError("ICC: out of bounds")
                stride, cpos = _decode_varint(enc, size, cpos)
                if stride < width:
                    raise JXLError("ICC: invalid stride")
            if not result or ((len(result) - 1) >> 2) < stride:
                raise JXLError("ICC: invalid stride")
            if cpos >= commands_end:
                raise JXLError("ICC: out of bounds")
            num, cpos = _decode_varint(enc, size, cpos)
            if pos + num > size:
                raise JXLError("ICC: out of bounds")
            shuffled = bytearray(enc[pos:pos + num])
            if width > 1:
                shuffled = _shuffle(shuffled, width)
            start = len(result)
            for i in range(num):
                predicted = _linear_predict(result, start, i, stride, width,
                                            order)
                result.append((predicted + shuffled[i]) & 255)
            pos += num
        elif command == CMD_XYZ:
            result += b"XYZ " + bytes(4)
            if pos + 12 > size:
                raise JXLError("ICC: out of bounds")
            result += enc[pos:pos + 12]
            pos += 12
        elif (CMD_TYPE_START_FIRST <= command
              < CMD_TYPE_START_FIRST + len(TYPE_STRINGS)):
            result += TYPE_STRINGS[command - CMD_TYPE_START_FIRST] + bytes(4)
        else:
            raise JXLError("ICC: unknown command")

    if pos != size:
        raise JXLError("ICC: not all data used")
    if len(result) != osize:
        raise JXLError("ICC: invalid result size")
    return bytes(result)


def _predict_and_shuffle(stride, width, order, num, icc, pos, data_add):
    """enc_icc_codec.cc:61-84: residuals against linear prediction, then
    de-interleave multi-byte values."""
    size = len(icc)
    if pos + num > size:
        raise JXLError("ICC: out of bounds")
    if not pos or ((pos - 1) >> 2) < stride or pos < stride * 4:
        raise JXLError("ICC: invalid stride")
    start = len(data_add)
    for i in range(num):
        predicted = _linear_predict(icc, pos, i, stride, width, order)
        data_add.append((icc[pos + i] - predicted) & 255)
    if width > 1:
        data_add[start:] = _unshuffle(data_add[start:], width)
    return pos + num


def predict_icc(icc: bytes) -> bytes:
    """Transform an ICC profile into the compressible (commands, data)
    representation (enc_icc_codec.cc:116-445). Accepts any byte string."""
    size = len(icc)
    if size > SIZE_LIMIT:
        raise JXLError("ICC profile too large")
    result = bytearray()
    commands = bytearray()
    data = bytearray()
    _encode_varint(size, result)

    # Header
    header = _initial_header_prediction(size)
    for i in range(min(ICC_HEADER_SIZE, size)):
        _predict_header(icc, size, header, i)
        data.append((icc[i] - header[i]) & 255)
    if size <= ICC_HEADER_SIZE:
        _encode_varint(0, result)  # 0 commands
        result += data
        return bytes(result)

    tags = []
    tagstarts = []
    tagsizes = []
    tagmap = {}

    # Tag list
    pos = ICC_HEADER_SIZE
    if pos + 4 <= size:
        numtags = _decode_u32be(icc, pos)
        pos += 4
        _encode_varint(numtags + 1, commands)
        prevtagstart = ICC_HEADER_SIZE + numtags * 12
        prevtagsize = 0
        i = 0
        while i < numtags:
            if pos + 12 > size:
                break
            tag = bytes(icc[pos:pos + 4])
            tagstart = _decode_u32be(icc, pos + 4)
            tagsize = _decode_u32be(icc, pos + 8)
            pos += 12
            tags.append(tag)
            tagstarts.append(tagstart)
            tagsizes.append(tagsize)
            tagmap[tagstart] = len(tags) - 1

            tagcode = CMD_TAG_UNKNOWN
            if tag in TAG_STRINGS:
                tagcode = TAG_STRINGS.index(tag) + CMD_TAG_STRING_FIRST

            if tag == b"rTRC" and pos + 24 < size:
                ok = (icc[pos:pos + 4] == b"gTRC"
                      and icc[pos + 12:pos + 16] == b"bTRC"
                      and icc[pos - 8:pos] == icc[pos + 4:pos + 12]
                      and icc[pos - 8:pos] == icc[pos + 16:pos + 24])
                if ok:
                    tagcode = CMD_TAG_TRC
                    pos += 24
                    i += 2
            if tag == b"rXYZ" and pos + 24 < size:
                ok = (icc[pos:pos + 4] == b"gXYZ"
                      and icc[pos + 12:pos + 16] == b"bXYZ"
                      and tagsize == 20
                      and _decode_u32be(icc, pos + 8) == 20
                      and _decode_u32be(icc, pos + 20) == 20
                      and _decode_u32be(icc, pos + 4) == tagstart + 20
                      and _decode_u32be(icc, pos + 16) == tagstart + 40)
                if ok:
                    tagcode = CMD_TAG_XYZ
                    pos += 24
                    i += 2

            command = tagcode
            if prevtagstart + prevtagsize != tagstart:
                command |= FLAG_BIT_OFFSET
            predicted_tagsize = 20 if tag in _SIZE20_TAGS else prevtagsize
            if predicted_tagsize != tagsize:
                command |= FLAG_BIT_SIZE
            commands.append(command)
            if tagcode == CMD_TAG_UNKNOWN:
                data += tag
            if command & FLAG_BIT_OFFSET:
                _encode_varint(tagstart, commands)
            if command & FLAG_BIT_SIZE:
                _encode_varint(tagsize, commands)
            prevtagstart, prevtagsize = tagstart, tagsize
            i += 1
    commands.append(0)  # end of tag list

    # Main content
    tag = b"\0\0\0\0"
    tagstart = 0
    tagsize = 0
    clutstart = 0

    def tag_sane():
        return 8 < tagsize < SIZE_LIMIT

    last0 = pos
    while pos <= size:
        last1 = pos
        commands_add = bytearray()
        data_add = bytearray()

        if pos > tagstart + tagsize and tagsize < SIZE_LIMIT:
            tag = b"\0\0\0\0"

        if pos in tagmap and pos + 4 <= size:
            index = tagmap[pos]
            tag = bytes(icc[pos:pos + 4])
            tagstart = tagstarts[index]
            tagsize = tagsizes[index]

            if (tag == b"mluc" and tag_sane() and pos + tagsize <= size
                    and icc[pos + 4:pos + 8] == bytes(4)):
                num = tagsize - 8
                commands_add.append(CMD_TYPE_START_FIRST + 3)
                pos += 8
                commands_add.append(CMD_SHUFFLE2)
                _encode_varint(num, commands_add)
                data_add += _unshuffle(bytearray(icc[pos:pos + num]), 2)
                pos += num
            elif (tag == b"curv" and tag_sane() and pos + tagsize <= size
                    and icc[pos + 4:pos + 8] == bytes(4)):
                num = tagsize - 8
                if 16 < num < (1 << 28) and pos + num <= size and pos > 0:
                    commands_add.append(CMD_TYPE_START_FIRST + 5)
                    pos += 8
                    commands_add.append(CMD_PREDICT)
                    order, width = 1, 2
                    commands_add.append((order << 2) | (width - 1))
                    _encode_varint(num, commands_add)
                    pos = _predict_and_shuffle(width, width, order, num, icc,
                                               pos, data_add)

        if tag in (b"mAB ", b"mBA "):
            sub = bytes(icc[pos:pos + 4]) if pos + 4 <= size else b""
            if (pos + 12 < size and sub in (b"curv", b"vcgt")
                    and _decode_u32be(icc, pos + 4) == 0):
                num = _decode_u32be(icc, pos + 8) * 2
                if 16 < num < (1 << 28) and pos + 12 + num <= size:
                    pos += 12
                    last1 = pos
                    commands_add.append(CMD_PREDICT)
                    order, width = 1, 2
                    commands_add.append((order << 2) | (width - 1))
                    _encode_varint(num, commands_add)
                    pos = _predict_and_shuffle(width, width, order, num, icc,
                                               pos, data_add)
            if pos == tagstart + 24 and pos + 4 < size:
                clutstart = tagstart + _decode_u32be(icc, pos)
            if pos == clutstart and clutstart + 16 < size:
                numi = icc[tagstart + 8]
                numo = icc[tagstart + 9]
                width = icc[clutstart + 16]
                stride = width * numo
                num = width * numo
                for k in range(numi):
                    if clutstart + k >= size:
                        break
                    num *= icc[clutstart + k]
                if (width in (1, 2) and 64 < num < (1 << 28)
                        and pos + num <= size and pos > stride * 4):
                    commands_add.append(CMD_PREDICT)
                    order = 1
                    flags = (order << 2) | (width - 1) \
                        | (0 if stride == width else 16)
                    commands_add.append(flags)
                    if flags & 16:
                        _encode_varint(stride, commands_add)
                    _encode_varint(num, commands_add)
                    pos = _predict_and_shuffle(stride, width, order, num, icc,
                                               pos, data_add)

        if (not commands_add and not data_add and tag == b"gbd "
                and tag_sane() and pos == tagstart + 8
                and pos + tagsize - 8 <= size and pos > 16):
            width, order = 4, 0
            stride = width
            num = tagsize - 8
            commands_add.append(CMD_PREDICT)
            commands_add.append((order << 2) | (width - 1))
            _encode_varint(num, commands_add)
            pos = _predict_and_shuffle(stride, width, order, num, icc, pos,
                                       data_add)

        if not commands_add and not data_add and pos + 20 <= size:
            if (icc[pos:pos + 4] == b"XYZ "
                    and _decode_u32be(icc, pos + 4) == 0):
                commands_add.append(CMD_XYZ)
                pos += 8
                data_add += icc[pos:pos + 12]
                pos += 12

        if not commands_add and not data_add and pos + 8 <= size:
            if _decode_u32be(icc, pos + 4) == 0:
                sub = bytes(icc[pos:pos + 4])
                if sub in TYPE_STRINGS:
                    commands_add.append(
                        CMD_TYPE_START_FIRST + TYPE_STRINGS.index(sub))
                    pos += 8

        if commands_add or data_add or pos == size:
            if last0 < last1:
                commands.append(CMD_INSERT)
                _encode_varint(last1 - last0, commands)
                data += icc[last0:last1]
            commands += commands_add
            data += data_add
            last0 = pos
        if not commands_add and not data_add:
            pos += 1

    _encode_varint(len(commands), result)
    result += commands
    result += data
    return bytes(result)


def read_icc(r: BitReader, output_limit: int = 1 << 28) -> bytes:
    """Read an entropy-coded ICC profile from the bitstream
    (icc_codec.cc ICCReader::Init/Process)."""
    from ..entropy.decode import ANSSymbolReader, decode_histograms

    enc_size = u64_read(r)
    if enc_size > 268435456:
        raise JXLError("ICC: too large encoded profile")
    code, cmap = decode_histograms(r, NUM_ICC_CONTEXTS)
    reader = ANSSymbolReader(code, r)
    dec = bytearray()
    b1 = b2 = 0
    for i in range(enc_size):
        b = reader.read_hybrid_uint(icc_context(i, b1, b2), r, cmap)
        if b > 255:
            raise JXLError("ICC: invalid byte")
        dec.append(b)
        b2 = b1
        b1 = b
    if not reader.check_final_state():
        raise JXLError("ICC: corrupted profile stream")
    return unpredict_icc(bytes(dec), output_limit=output_limit)


def write_icc(icc: bytes, w: BitWriter) -> None:
    """Entropy-code an ICC profile into the bitstream
    (enc_icc_codec.cc:415-445 WriteICC)."""
    from ..entropy.encode import (Token, build_and_encode_histograms,
                                  write_tokens)

    if not icc:
        raise JXLError("ICC must be non-empty")
    enc = predict_icc(icc)
    u64_write(len(enc), w)
    tokens = []
    b1 = b2 = 0
    for i, b in enumerate(enc):
        tokens.append(Token(icc_context(i, b1, b2), b))
        b2 = b1
        b1 = b
    codes, cmap = build_and_encode_histograms([tokens], NUM_ICC_CONTEXTS, w)
    write_tokens(tokens, codes, cmap, w)
