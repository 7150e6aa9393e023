"""Make the JPEG 2000 fixtures of this folder and their ``digests.json``.

    python tests/data/jpeg2000/make_fixtures.py

Seeded synthetic images written by PIL (OpenJPEG's encoder), one file per
variant the port's reader (``crdr_tpu_torch/utils/jpeg2000.py``,
``runtime/csrc/jpeg2000.cpp``) is held to: reversible (5/3) and
irreversible (9/7) wavelets, with and without the colour transform, the
five progression orders with precincts, small code-blocks and three
quality layers, tiles at an offset, an image offset, odd and one-pixel
sizes, bare codestreams, the modes L, LA, RGB, RGBA, I;16, YCbCr (sYCC)
and CMYK, signed samples, a comment, PLT markers.  Four 768x512 files
time the decoder (``synthetic_images(1, 512, 768, 25)`` of
``crdr_tpu_torch/cli/serve_smoke.py``): reversible, irreversible at rate
20, irreversible in 256x256 tiles in RPCL order, and a bare codestream of
two quality layers.

Edited by hand from those (PIL's writer sets none of these): precisions
of 4, 10 and 12 bits in SIZ; a palette (``pclr`` / ``cmap``, with 16-bit
entries, duplicates, without ``cmap``, over LA); channel definitions that
swap channels or are incomplete; ``colr`` as an ICC profile, unknown or
gray / eYCC spaces, twice, or absent; an ``ihdr`` of another size;
XLBox and zero box lengths; the code-block styles (bypass, reset,
termination on each pass, vertically causal, predictable termination,
segmentation symbols, high-throughput) set in COD, an RGN marker, POC
markers that restate or split the progression or contradict it (the
files then decode to other pixels, the same in every OpenJPEG decoder);
PPM / PPT markers, truncation and a missing EOC.

``digests.json`` holds, for each file, ``cv2``: the sha256 of
``cv2.imread``'s RGB of the file (null where it returns None, with the
port's reason in ``file_refused``); ``body`` / ``body_shape``: the sha256
and shape of PIL's ``convert("RGB")``, or, where PIL raises, its message
(``pil``) and the port's reason (``refused``).
``tests/test_torch_jpeg2000.py`` recomputes them.
"""

import hashlib
import io
import json
import os
import re
import struct
import sys

import numpy as np

import cv2
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

# the port's reason where cv2.imread returns None
FILE_REFUSED = {
    "cmyk.jp2": "CMYK colour space", "colr_eycc.jp2": "eYCC colour space",
    "colr_meth3_l.jp2": "components in the sRGB", "i16.j2k": "sRGB",
    "l.j2k": "sRGB", "la.j2k": "sRGB", "no_colr_l.jp2": "sRGB",
    "colr_icc_l.jp2": "sRGB", "pclr_no_cmap.jp2": "sRGB",
    "offset.jp2": "image offset", "tiles_offset.jp2": "image offset",
    "signed_rgb.jp2": "is signed", "signed_l.jp2": "is signed",
    "prec4_l.jp2": "4-bit components", "cdef_incomplete.jp2":
    "incomplete JP2 channel definitions", "pclr_la.jp2": "incomplete JP2",
    "ihdr_size.jp2": "JP2 ihdr of 52x30", "style_ht.jp2": "high-throughput",
    "ppm.jp2": "PPM marker", "ppt.jp2": "PPT marker",
    "refused_truncated.jp2": "truncated JPEG 2000 tile-part",
    "refused_no_eoc.jp2": "without EOC"}
# the port's reason where PIL raises
BODY_REFUSED = {
    "colr_eycc.jp2": "mode RGB of 3 components",
    "colr_gray_rgb.jp2": "mode RGB of 3 components",
    "pclr_16bit.jp2": "mode L of 1 components",
    "ihdr_size.jp2": "JP2 ihdr of 52x30", "style_ht.jp2": "high-throughput",
    "ppm.jp2": "PPM marker", "ppt.jp2": "PPT marker",
    "refused_truncated.jp2": "truncated JPEG 2000 tile-part",
    "refused_no_eoc.jp2": "without EOC"}


def synthetic(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Blurred noise over a ramp: uint8 [h, w, c]."""
    rng = np.random.default_rng(seed)
    a = cv2.GaussianBlur(rng.integers(0, 256, (h, w, c), np.uint8), (0, 0),
                         2.0).reshape(h, w, c)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.clip(a.astype(int) + ((xx * 3 + yy * 2)[..., None] % 64), 0,
                   255).astype(np.uint8)


def save(img, mode=None, **kw) -> bytes:
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img[..., 0] if img.shape[-1] == 1 else img,
                              mode)
    b = io.BytesIO()
    img.save(b, "JPEG2000", **kw)
    return b.getvalue()


def boxes(data: bytes) -> list:
    """[[type, payload], ...] of a JP2's top-level (or a box's) boxes."""
    out, pos = [], 0
    while pos < len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        n = n or len(data) - pos
        out.append([kind, data[pos + 8:pos + n]])
        pos += n
    return out


def build(bs) -> bytes:
    return b"".join(struct.pack(">I4s", len(p) + 8, k) + p for k, p in bs)


def edit_jp2h(data: bytes, fn) -> bytes:
    """The JP2 with its header box's boxes passed through fn."""
    bs = boxes(data)
    for b in bs:
        if b[0] == b"jp2h":
            b[1] = build(fn(boxes(b[1])))
    return build(bs)


def colr(payload: bytes):
    def fn(bs):
        for b in bs:
            if b[0] == b"colr":
                b[1] = payload
        return bs
    return fn


def enum(cs: int) -> bytes:
    return bytes([1, 0, 0]) + struct.pack(">I", cs)


def ihdr(h: int, w: int):
    def fn(bs):
        for b in bs:
            if b[0] == b"ihdr":
                b[1] = struct.pack(">II", h, w) + b[1][8:]
        return bs
    return fn


def pclr(entries: np.ndarray, depth: int, cmap, space: int = 16):
    """Add a pclr (and a cmap unless None) box; colr set to ``space``."""
    ne, npc = entries.shape
    nb = (depth + 7) // 8
    body = struct.pack(">HB", ne, npc) + bytes([depth - 1] * npc) + b"".join(
        int(v).to_bytes(nb, "big") for v in entries.ravel())

    def fn(bs):
        colr(enum(space))(bs)
        bs = bs + [[b"pclr", body]]
        if cmap is not None:
            bs.append([b"cmap", b"".join(struct.pack(">HBB", *c)
                                         for c in cmap)])
        return bs
    return fn


def cdef(entries):
    def fn(bs):
        return [b for b in bs if b[0] != b"cdef"] + [[b"cdef", struct.pack(
            ">H", len(entries)) + b"".join(struct.pack(">HHH", *e)
                                           for e in entries)]]
    return fn


def siz_comp(data: bytes, c: int, ssiz: int) -> bytes:
    """Set component c's Ssiz (sign bit, precision - 1) in SIZ."""
    i = data.find(b"\xff\x51")
    out = bytearray(data)
    out[i + 40 + 3 * c] = ssiz
    return bytes(out)


def cod_style(data: bytes, style: int) -> bytes:
    """Set COD's code-block style byte."""
    i = data.find(b"\xff\x52")
    out = bytearray(data)
    out[i + 12] = style
    return bytes(out)


def main_marker(data: bytes, seg: bytes) -> bytes:
    """A marker segment put at the end of the main header."""
    i = data.find(b"\xff\x90")
    return data[:i] + seg + data[i:]


def poc(entries) -> bytes:
    return b"\xff\x5f" + struct.pack(">H", 2 + 7 * len(entries)) + b"".join(
        struct.pack(">BBHBBB", *e) for e in entries)


def fixtures() -> dict:
    """{file name: bytes}."""
    from crdr_tpu_torch.cli.serve_smoke import synthetic_images
    out = {}
    photo = synthetic_images(1, 512, 768, 25)[0]
    out["photo_768x512_reversible.jp2"] = save(photo)
    out["photo_768x512_irreversible_rate20.jp2"] = save(
        photo, irreversible=True, quality_layers=[20])
    out["photo_768x512_tiled_rpcl.jp2"] = save(
        photo, irreversible=True, tile_size=(256, 256), progression="RPCL")
    out["photo_768x512_layers.j2k"] = save(
        photo, no_jp2=True, irreversible=True, quality_layers=[40, 10])
    rgb = synthetic(96, 128, 3, 1)
    out["rgb_cblk16_prc32_cprl_plt.jp2"] = save(
        rgb, codeblock_size=(16, 16), precinct_size=(32, 32),
        num_resolutions=3, progression="CPRL", plt=True)
    for prg in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        out[f"prg_{prg.lower()}.jp2"] = save(
            synthetic(70, 90, 3, 4), progression=prg, precinct_size=(32, 32),
            codeblock_size=(16, 16), num_resolutions=4,
            quality_layers=[40, 10, 1])
    out["rgba.jp2"] = save(synthetic(96, 128, 4, 2), "RGBA")
    out["la.jp2"] = save(synthetic(96, 128, 2, 3), "LA")
    out["l.jp2"] = save(synthetic(96, 128, 1, 4))
    out["rgb_irreversible_mct0.jp2"] = save(rgb, irreversible=True, mct=0)
    out["rgb_irreversible_mct1.jp2"] = save(rgb, irreversible=True, mct=1)
    out["rgb_reversible_mct1.jp2"] = save(rgb, mct=1)
    small = synthetic(40, 52, 3, 5)
    out["rgb.j2k"] = save(small, no_jp2=True)
    out["rgba.j2k"] = save(synthetic(40, 52, 4, 6), "RGBA", no_jp2=True)
    out["la.j2k"] = save(synthetic(40, 52, 2, 7), "LA", no_jp2=True)
    gray = synthetic(40, 52, 1, 8)
    out["l.j2k"] = save(gray, no_jp2=True)
    out["size_37x53.jp2"] = save(synthetic(37, 53, 3, 9))
    out["size_37x53_irreversible.jp2"] = save(synthetic(37, 53, 3, 9),
                                              irreversible=True, mct=1)
    out["size_1x1.jp2"] = save(synthetic(1, 1, 3, 10))
    out["size_1x7.jp2"] = save(synthetic(1, 7, 3, 11), irreversible=True)
    out["size_7x1.jp2"] = save(synthetic(7, 1, 3, 12))
    out["size_3x5_irreversible.jp2"] = save(synthetic(3, 5, 3, 13),
                                            irreversible=True)
    out["tiles_32.jp2"] = save(synthetic(96, 128, 3, 14), tile_size=(32, 32))
    out["tiles_offset.jp2"] = save(synthetic(96, 128, 3, 15),
                                   tile_size=(24, 20), tile_offset=(3, 2),
                                   offset=(5, 4), irreversible=True)
    out["offset.jp2"] = save(synthetic(37, 53, 3, 16), offset=(5, 3),
                             tile_offset=(0, 0), tile_size=(64, 64))
    i16 = Image.fromarray(synthetic(40, 52, 1, 17)[..., 0].astype(np.uint16)
                          * 257)
    out["i16.jp2"] = save(i16)
    out["i16.j2k"] = save(i16, no_jp2=True)
    out["signed_rgb.jp2"] = save(small, signed=True)
    out["signed_l.jp2"] = save(gray, signed=True)
    ycc = Image.fromarray(small).convert("YCbCr")
    out["ycbcr.jp2"] = save(ycc)
    out["ycbcr_irreversible.jp2"] = save(ycc, irreversible=True, mct=1)
    out["ycbcr_photo.jp2"] = save(Image.fromarray(synthetic(96, 128, 3, 21))
                                  .convert("YCbCr"))
    cmyk = Image.fromarray(synthetic(40, 52, 4, 18), "CMYK")
    out["cmyk.jp2"] = save(cmyk)
    out["cmyk.j2k"] = save(cmyk, no_jp2=True)
    out["comment.jp2"] = save(small, comment="crdr fixture")
    # edited by hand
    jp2_l = save(gray)
    jp2_rgb = save(small)
    out["prec12_i16.jp2"] = siz_comp(out["i16.jp2"], 0, 11)
    out["prec10_l.jp2"] = siz_comp(jp2_l, 0, 9)
    out["prec4_l.jp2"] = siz_comp(jp2_l, 0, 3)
    out["prec12_rgb_c1.jp2"] = siz_comp(jp2_rgb, 1, 11)
    rng = np.random.default_rng(19)
    pal = rng.integers(0, 256, (256, 3))
    out["pclr_256x3.jp2"] = edit_jp2h(jp2_l, pclr(
        pal, 8, [(0, 1, 0), (0, 1, 1), (0, 1, 2)]))
    dup = rng.integers(0, 256, (100, 3))
    dup[7] = dup[2]
    out["pclr_100x3_dup.jp2"] = edit_jp2h(jp2_l, pclr(
        dup, 8, [(0, 1, 0), (0, 1, 1), (0, 1, 2)]))
    out["pclr_16bit.jp2"] = edit_jp2h(jp2_l, pclr(
        rng.integers(0, 65536, (256, 3)), 16,
        [(0, 1, 0), (0, 1, 1), (0, 1, 2)]))
    out["pclr_no_cmap.jp2"] = edit_jp2h(jp2_l, pclr(pal, 8, None))
    out["pclr_la.jp2"] = edit_jp2h(save(synthetic(40, 52, 2, 20), "LA"), pclr(
        pal, 8, [(0, 1, 0), (0, 1, 1), (0, 1, 2), (1, 0, 0)]))
    out["cdef_swap.jp2"] = edit_jp2h(jp2_rgb, cdef([(0, 0, 3), (1, 0, 2),
                                                    (2, 0, 1)]))
    out["cdef_incomplete.jp2"] = edit_jp2h(jp2_rgb, cdef([(0, 0, 1),
                                                          (1, 0, 2)]))
    icc = bytes([2, 0, 0]) + bytes(range(128))
    out["colr_icc_rgb.jp2"] = edit_jp2h(jp2_rgb, colr(icc))
    out["colr_icc_l.jp2"] = edit_jp2h(jp2_l, colr(icc))
    out["colr_enum99.jp2"] = edit_jp2h(jp2_rgb, colr(enum(99)))
    out["colr_meth3_l.jp2"] = edit_jp2h(jp2_l, colr(bytes([3, 0, 0])
                                                    + enum(16)[3:]))
    out["colr_gray_rgb.jp2"] = edit_jp2h(jp2_rgb, colr(enum(17)))
    out["colr_eycc.jp2"] = edit_jp2h(jp2_rgb, colr(enum(24)))
    out["colr_twice.jp2"] = edit_jp2h(jp2_rgb, lambda bs: bs + [
        [b"colr", enum(17)]])
    out["no_colr_l.jp2"] = edit_jp2h(jp2_l, lambda bs: [
        b for b in bs if b[0] != b"colr"])
    out["ihdr_size.jp2"] = edit_jp2h(jp2_rgb, ihdr(30, 52))
    bs = boxes(jp2_rgb)
    out["xlbox.jp2"] = b"".join(
        struct.pack(">I4sQ", 1, k, len(p) + 16) + p if k == b"jp2c"
        else struct.pack(">I4s", len(p) + 8, k) + p for k, p in bs)
    out["jp2c_length_0.jp2"] = b"".join(
        struct.pack(">I4s", 0, k) + p if k == b"jp2c"
        else struct.pack(">I4s", len(p) + 8, k) + p for k, p in bs)
    for name, style in (("reset", 2), ("vsc", 8), ("pterm", 16),
                        ("segsym", 32), ("bypass", 1), ("termall", 4),
                        ("all", 0x3F), ("ht", 0x40)):
        out[f"style_{name}.jp2"] = cod_style(jp2_rgb, style)
    out["style_bypass_l.jp2"] = cod_style(jp2_l, 1)
    out["style_termall_l.jp2"] = cod_style(jp2_l, 4)
    out["rgn_3.jp2"] = main_marker(jp2_rgb, b"\xff\x5e\x00\x05\x00\x00\x03")
    out["rgn_7_l.jp2"] = main_marker(jp2_l, b"\xff\x5e\x00\x05\x00\x00\x07")
    out["poc_restated.jp2"] = main_marker(jp2_rgb, poc([(0, 0, 1, 6, 3, 0)]))
    rpcl = save(small, progression="RPCL", precinct_size=(32, 32),
                codeblock_size=(8, 8), num_resolutions=4)
    out["poc_rpcl_split.jp2"] = main_marker(rpcl, poc([(0, 0, 1, 2, 3, 2),
                                                       (0, 0, 1, 33, 3, 2)]))
    cprl = save(small, progression="CPRL", precinct_size=(32, 32),
                codeblock_size=(8, 8), num_resolutions=4)
    out["poc_cprl_split.jp2"] = main_marker(cprl, poc([(0, 0, 1, 33, 1, 4),
                                                       (0, 1, 1, 33, 3, 4)]))
    out["poc_contradicts.jp2"] = main_marker(cprl, poc([(0, 0, 1, 33, 3,
                                                         0)]))
    out["ppm.jp2"] = main_marker(jp2_rgb, b"\xff\x60\x00\x03\x00")
    i = jp2_rgb.find(b"\xff\x90")
    psot = struct.unpack_from(">I", jp2_rgb, i + 6)[0]
    ppt = bytearray(jp2_rgb[:i + 12] + b"\xff\x61\x00\x03\x00"
                    + jp2_rgb[i + 12:])
    struct.pack_into(">I", ppt, i + 6, psot + 5)
    out["ppt.jp2"] = bytes(ppt)
    out["refused_truncated.jp2"] = jp2_rgb[:len(jp2_rgb) // 2]
    out["refused_no_eoc.jp2"] = jp2_rgb[:-2]
    out["trailing_bytes.jp2"] = jp2_rgb + b"\0" * 10
    return out


def pil_message(e: Exception) -> str:
    """PIL's error message without the reprs of its objects."""
    return re.sub(r" <[^>]*>", "", str(e))


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


def cv2_record(path: str):
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    return None if bgr is None else sha(bgr[..., ::-1])


def write(here: str, files: dict, file_refused: dict, body_refused: dict
          ) -> None:
    """Write ``files`` and their ``digests.json`` into ``here`` (module
    doc); a file whose oracles refuse it without a reason listed here is an
    error."""
    digests = {}
    for name, data in sorted(files.items()):
        path = os.path.join(here, name)
        with open(path, "wb") as f:
            f.write(data)
        entry = {"cv2": cv2_record(path)}
        if (entry["cv2"] is None) != (name in file_refused):
            raise AssertionError(f"cv2 and the list part on {name}")
        if name in file_refused:
            entry["file_refused"] = file_refused[name]
        try:
            rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception as e:  # noqa: BLE001 - PIL raises several types
            if name not in body_refused:
                raise AssertionError(f"PIL refuses {name}: {e}")
            entry.update(refused=body_refused[name], pil=pil_message(e))
        else:
            if name in body_refused:
                raise AssertionError(f"PIL reads {name}")
            entry.update(body=sha(rgb), body_shape=list(rgb.shape))
        digests[name] = entry
    with open(os.path.join(here, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    write(HERE, fixtures(), FILE_REFUSED, BODY_REFUSED)
