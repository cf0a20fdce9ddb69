"""Regenerate ``citlab_as_tpu_torch/csrc/av1_tables.h``, the constant tables
of the AV1 intra-frame decoder (``csrc/av1_decode.cpp``).

The tables are read out of the libavif that PIL 12.1 ships
(``pillow.libs/libavif-*.so``), which links dav1d 1.5.1 (its decoder) and
aom 3.12.1 (its encoder); both carry AV1's default tables. Each table is
found by an anchor, a run of its own first values in the layout the library
stores it in, that must occur exactly once; then its shape is checked
(every CDF strictly below 32768 and decreasing, a zero where the CDF ends,
a zero count). The sources, by table:

- aom's arrays (``entropymode.c``, ``token_cdfs.h``; stored as
  ``32768 - cdf`` with a terminating 0 and a zero count per CDF): the
  key-frame y mode, uv mode, angle delta, partition, CfL alpha and
  filter-intra use CDFs, and all coefficient CDFs of the four qindex sets;
- dav1d's default ``CdfModeContext`` (``32768 - cdf``, the count in place of
  the last value): the intra and inter (IntraBC) transform types, the
  transform split, CfL sign, filter-intra mode,
  segment id, palette sizes and colour maps, transform depth, delta q / lf,
  skip, palette use and IntraBC;
- aom: the 8-, 10- and 12-bit DC and AC quantizer lookups, the inverse quantizer
  matrices (15 levels, luma and chroma, 3344 weights each), the smooth
  weights, the directional-prediction derivatives and the filter-intra taps;
  dav1d: the coefficient-context offsets of square, wide and tall blocks,
  the loop-restoration CDFs (switchable type, use_wiener, use_sgrproj), the
  self-guided parameter sets, the CDEF directions and the superres
  upscaling filter; its self-guided 1 / x table is checked against the
  specification's formula; the film grain's Gaussian sequence.

The motion-vector CDFs of IntraBC are written here as the AV1 default
context (joints, classes, class0, bits, sign) and checked against dav1d's
copy. The cosine and sine constants are computed and checked against aom's.

Run: ``python scripts/make_av1_tables.py [--so PATH]`` (needs PIL 12.1's
wheel for the default path).
"""
from __future__ import annotations

import argparse
import glob
import math
import os

import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "..", "citlab_as_tpu_torch", "csrc",
                   "av1_tables.h")


def default_so() -> str:
    import PIL
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    hits = glob.glob(os.path.join(libs, "libavif-*.so*"))
    if not hits:
        raise SystemExit(f"no libavif in {libs}")
    return hits[0]


class Image:
    def __init__(self, path: str):
        self.raw = open(path, "rb").read()

    def find(self, values, dtype) -> int:
        needle = np.asarray(values, dtype).tobytes()
        first = self.raw.find(needle)
        if first < 0:
            raise SystemExit(f"anchor {list(values)[:8]} not found")
        if self.raw.find(needle, first + 1) >= 0:
            raise SystemExit(f"anchor {list(values)[:8]} is not unique")
        return first

    def read(self, off: int, n: int, dtype) -> np.ndarray:
        size = np.dtype(dtype).itemsize
        return np.frombuffer(self.raw[off:off + n * size], dtype).copy()


def check_cdf(row, nsym, name, dav1d):
    """One CDF row: nsym - 1 decreasing values in (0, 32768), then zeros
    (aom: the end and the count; dav1d: the count)."""
    vals = row[:nsym - 1].astype(np.int64)
    if np.any(vals <= 0) or np.any(vals >= 32768) or np.any(np.diff(vals) > 0):
        raise SystemExit(f"{name}: not a CDF of {nsym} symbols: {row}")
    tail = row[nsym - 1:nsym] if dav1d else row[nsym - 1:nsym + 1]
    if np.any(tail != 0):
        raise SystemExit(f"{name}: CDF of {nsym} symbols not closed: {row}")


def cdf_table(img, name, anchor, shape, stride, nsym, dav1d=False, offset=None, out_stride=None,
              skip=0):
    """Read a CDF table and re-emit it in aom's layout: nsym - 1 values, 0,
    count 0, padded to ``out_stride``."""
    count = int(np.prod(shape))
    off = img.find(anchor, "<u2") + 2 * skip if offset is None else offset
    a = img.read(off, count * stride, "<u2").reshape(count, stride)
    out_stride = out_stride or max(nsym(i) for i in range(count)) + 1
    out = np.zeros((count, out_stride), np.uint16)
    for i in range(count):
        n = nsym(i)
        check_cdf(a[i], n, f"{name}[{i}]", dav1d)
        out[i, :n - 1] = a[i, :n - 1]
    return name, out.reshape(*shape, out_stride), off + count * stride * 2


def fmt(name, arr, ctype):
    dims = "".join(f"[{d}]" for d in arr.shape)
    flat = arr.reshape(-1)
    body = []
    for i in range(0, len(flat), 16):
        body.append("    " + ", ".join(str(int(v)) for v in flat[i:i + 16]) + ",")
    return f"static const {ctype} {name}{dims} = {{\n" + "\n".join(body) + "\n};\n"


MV_DEFAULT = {
    # the AV1 default motion-vector context (both components alike)
    "joints": [4096, 11264, 19328],
    "classes": [28672, 30976, 31858, 32320, 32551, 32656, 32740, 32757, 32762, 32767],
    "class0": [216 * 128],
    "bits": [128 * v for v in (136, 140, 148, 160, 176, 192, 224, 234, 234, 240)],
    "sign": [128 * 128],
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--so", default=None)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    img = Image(args.so or default_so())
    tabs = []

    def const(n):
        return lambda i: n

    # aom arrays
    tabs.append(cdf_table(img, "kf_y_mode_cdf", [17180, 15741, 13430, 12550, 12086, 11658, 10943,
                                                  9524, 8579, 4603, 3675, 2302, 0, 0, 20752],
                          (5, 5), 14, const(13)))
    tabs.append(cdf_table(img, "uv_mode_cdf", [10137, 8616, 7390, 7107, 6782, 6248, 5713, 4845,
                                               4524, 2709, 1827, 807, 0, 0, 0, 23255],
                          (2, 13), 15, lambda i: 13 if i < 13 else 14))
    tabs.append(cdf_table(img, "angle_delta_cdf", [5796, 4425, 474, 0, 30588, 27736, 25201, 9992],
                          (8,), 8, const(7), dav1d=True, skip=4))
    tabs.append(cdf_table(img, "partition_cdf", [13636, 7258, 2376, 0, 0, 0, 0, 0, 0, 0, 0,
                                                 18840], (20,), 11,
                          lambda i: 4 if i < 4 else (10 if i < 16 else 8)))
    tabs.append(cdf_table(img, "cfl_alpha_cdf", [25131, 12049, 1367, 287, 111, 80, 76, 72, 68,
                                                 64, 60, 56, 52, 48, 44, 0, 0, 18403],
                          (6,), 17, const(16)))
    tabs.append(cdf_table(img, "use_filter_intra_cdf", [28147, 0, 0, 26025, 0, 0, 26875],
                          (22,), 3, const(2)))
    # aom's token_cdfs.h, contiguous from the 1024-eob table on
    name, t, end = cdf_table(img, "eob_pt_1024_cdf", [32375, 32347, 32017, 31145, 29608, 26416,
                              19423, 14721, 10197, 6938, 0, 0, 29789],
                             (4, 2, 2), 12, const(11))
    tabs.append((name, t, end))
    for n, sym in ((512, 10), (256, 9), (128, 8), (64, 7), (32, 6), (16, 5)):
        name, t, end = cdf_table(img, f"eob_pt_{n}_cdf", None, (4, 2, 2), sym + 1, const(sym),
                                 offset=end)
        tabs.append((name, t, end))
    name, t, end = cdf_table(img, "coeff_base_eob_cdf", None, (4, 5, 2, 4), 4, const(3),
                             offset=end)
    tabs.append((name, t, end))
    name, t, end = cdf_table(img, "coeff_base_cdf", None, (4, 5, 2, 42), 5, const(4), offset=end)
    tabs.append((name, t, end))
    name, t, end = cdf_table(img, "coeff_br_cdf", None, (4, 5, 2, 21), 5, const(4), offset=end)
    tabs.append((name, t, end))
    # the split between the base and br tables: both start at their anchors
    assert img.find([28734, 23838, 20041, 0, 0, 14686], "<u2") == tabs[-2][2] - 1680 * 10
    assert img.find([18470, 12050, 8594, 0, 0], "<u2") == tabs[-1][2] - 840 * 10
    eob_extra = cdf_table(img, "eob_extra_cdf", [15807, 0, 0, 15545, 0, 0, 25147],
                          (4, 5, 2, 9), 3, const(2))
    # the dc sign table (the same in all four sets) is aligned 160 bytes before it
    dc_sign = cdf_table(img, "dc_sign_cdf", None, (4, 2, 3), 3, const(2),
                        offset=eob_extra[2] - 360 * 6 - 160)
    assert all(np.array_equal(dc_sign[1][q], dc_sign[1][0]) for q in range(4))
    assert dc_sign[1][0, 0, 0, 0] == 32768 - 125 * 128
    tabs += [dc_sign, eob_extra]
    tabs.append(cdf_table(img, "txb_skip_cdf", [919, 0, 0, 26876, 0, 0, 20656],
                          (4, 5, 13), 3, const(2)))
    # dav1d's CdfModeContext
    tabs.append(cdf_table(img, "inter_tx_set1_cdf", [28310, 27208, 25073, 23059, 19438, 17979,
                                                     15231, 12502, 11264, 9920, 8834, 7294,
                                                     5041, 3853, 2137, 0, 31123], (2,), 16,
                          const(16), dav1d=True))
    tabs.append(cdf_table(img, "inter_tx_set2_cdf", [31998, 30347, 27543, 19861, 16949, 13841,
                                                     11207, 8679, 6173, 4242, 2239, 0, 0, 0, 0,
                                                     0, 31233], (1,), 16, const(12), dav1d=True))
    tabs.append(cdf_table(img, "inter_tx_set3_cdf", [16384, 0, 28601, 0, 30770, 0, 32020, 0],
                          (4,), 2, const(2), dav1d=True))
    tabs.append(cdf_table(img, "txfm_split_cdf", [4187, 0, 8922, 0, 11921, 0, 8453], (21,), 2,
                          const(2), dav1d=True))
    name, t, end = cdf_table(img, "intra_tx_set1_cdf", [31233, 24733, 23307, 20017, 9301, 4943,
                                                        0, 0, 32204], (2, 13), 8, const(7),
                             dav1d=True)
    tabs.append((name, t, end))
    tabs.append(cdf_table(img, "intra_tx_set2_cdf", None, (3, 13), 8, const(5), dav1d=True,
                          offset=end))
    tabs.append(cdf_table(img, "cfl_sign_cdf", [31350, 30645, 19428, 14363, 5796, 4425, 474, 0,
                                                30588], (1,), 8, const(8), dav1d=True))
    tabs.append(cdf_table(img, "filter_intra_mode_cdf", [23819, 19992, 15557, 3210, 0, 0, 0, 0,
                                                         27146], (1,), 8, const(5), dav1d=True))
    tabs.append(cdf_table(img, "segment_id_cdf", [27146, 24875, 16675, 14535, 4959, 4395, 235,
                                                  0, 18494], (3,), 8, const(8), dav1d=True))
    tabs.append(cdf_table(img, "palette_size_cdf", [371, 121, 89, 0, 24816, 19768, 14619, 11290],
                          (2, 7), 8, const(7), dav1d=True, skip=4))
    tabs.append(cdf_table(img, "palette_color_cdf", [4058, 0, 0, 0, 0, 0, 0, 0, 16384],
                          (2, 7, 5), 8, lambda i: (i // 5) % 7 + 2, dav1d=True, out_stride=9))
    tabs.append(cdf_table(img, "tx_depth_cdf", [943, 742, 446, 0, 12800, 0, 0, 0, 12800],
                          (4, 3), 4, lambda i: 2 if i < 3 else 3, dav1d=True, skip=4))
    name, t, end = cdf_table(img, "delta_q_cdf", [4608, 648, 91, 0] * 6 + [23355, 10187],
                             (1,), 4, const(4), dav1d=True)
    tabs.append((name, t, end))
    tabs.append(cdf_table(img, "delta_lf_cdf", None, (5,), 4, const(4), dav1d=True, offset=end))
    tabs.append(cdf_table(img, "skip_cdf", [1097, 0, 16253, 0, 28192, 0], (3,), 2, const(2),
                          dav1d=True))
    tabs.append(cdf_table(img, "palette_y_mode_cdf", [1092, 0, 29349, 0, 31507, 0], (7, 3), 2,
                          const(2), dav1d=True))
    name, t, end = cdf_table(img, "palette_uv_mode_cdf", [307, 0, 11280, 0, 2237, 0], (2,), 2,
                             const(2), dav1d=True)
    tabs.append((name, t, end))
    tabs.append(cdf_table(img, "intrabc_cdf", None, (1,), 2, const(2), dav1d=True, offset=end))
    # loop restoration: switchable (3 symbols), use_wiener, use_sgrproj
    name, t, end = cdf_table(img, "restoration_type_cdf", [23355, 10187, 0, 0, 21198, 0, 15913],
                             (1,), 4, const(3), dav1d=True)
    tabs.append((name, t, end))
    name, t, end = cdf_table(img, "use_wiener_cdf", None, (1,), 2, const(2), dav1d=True,
                             offset=end)
    tabs.append((name, t, end))
    tabs.append(cdf_table(img, "use_sgrproj_cdf", None, (1,), 2, const(2), dav1d=True,
                          offset=end))

    # the motion-vector context: written from the standard, found in dav1d
    for key in ("classes", "joints"):
        needle = np.array([32768 - v for v in MV_DEFAULT[key]] + [0], "<u2").tobytes()
        assert needle in img.raw, key
    mv = []
    for key, vals in MV_DEFAULT.items():
        rows = [vals] if key != "bits" else [[v] for v in vals]
        n = len(rows[0]) + 1
        out = np.zeros((len(rows), n + 1), np.uint16)
        for i, r in enumerate(rows):
            out[i, :n - 1] = [32768 - v for v in r]
        mv.append((f"mv_{key}_cdf", out if key == "bits" else out[0]))

    other = []
    dc = img.read(img.find([4, 8, 8, 9, 10, 11, 12, 12, 13, 14], "<i2"), 256, "<i2")
    ac = img.read(img.find([4, 8, 9, 10, 11, 12, 13, 14, 15, 16], "<i2"), 256, "<i2")
    assert dc[-1] == 1336 and ac[-1] == 1828, (dc[-1], ac[-1])
    dc10 = img.read(img.find([4, 9, 10, 13, 15, 17, 20, 22, 25, 28], "<i2"), 256, "<i2")
    ac10 = img.read(img.find([4, 9, 11, 13, 16, 18, 21, 24, 27, 30], "<i2"), 256, "<i2")
    dc12 = img.read(img.find([4, 12, 18, 25, 33, 41, 50, 60, 70, 80], "<i2"), 256, "<i2")
    ac12 = img.read(img.find([4, 13, 19, 27, 35, 44, 54, 64, 75, 87], "<i2"), 256, "<i2")
    assert (dc10[-1], ac10[-1], dc12[-1], ac12[-1]) == (5347, 7312, 21387, 29247)
    for t in (dc10, ac10, dc12, ac12):
        assert np.all(np.diff(t.astype(np.int64)) > 0)
    other += [("dc_qlookup", np.stack([dc, dc10, dc12]), "int16_t"),
              ("ac_qlookup", np.stack([ac, ac10, ac12]), "int16_t")]
    qm = img.read(img.find([32, 43, 73, 97, 43, 67, 94, 110, 73, 94], "<u1"), 15 * 2 * 3344,
                  "<u1").reshape(15, 2, 3344)
    assert qm.min() >= 30 and qm[14].max() <= 40
    other.append(("qm_iwt", qm, "uint8_t"))
    sm_off = img.raw.find(np.array([255, 149, 85, 64, 255, 197, 146, 105, 73, 50, 37, 32, 255],
                                   np.uint8).tobytes())
    sm = img.read(sm_off, 4 + 8 + 16 + 32 + 64, "<u1")
    assert all(sm[o] == 255 for o in (0, 4, 12, 28, 60))
    other.append(("smooth_weights", sm, "uint8_t"))
    dr = img.read(img.find([0, 0, 0, 1023, 0, 0, 547, 0, 0, 372], "<u2"), 90, "<u2")
    other.append(("dr_intra_derivative", dr, "uint16_t"))
    taps = img.read(img.find([-6, 10, 0, 0, 0, 12, 0, 0, -5, 2, 10], "<i1"), 5 * 8 * 8,
                    "<i1").reshape(5, 8, 8)[:, :, :7]
    other.append(("filter_intra_taps", np.ascontiguousarray(taps), "int8_t"))
    lo = img.read(img.find([0, 1, 6, 6, 21, 1, 6, 6, 21, 21, 6, 6, 21, 21, 21], "<u1"), 75,
                  "<u1").reshape(3, 5, 5)
    other.append(("lo_ctx_offsets", lo, "uint8_t"))
    cospi = np.array([round(4096 * math.cos(i * math.pi / 128)) for i in range(64)], np.int32)
    off = img.find(cospi[:8], "<i4")
    assert np.array_equal(img.read(off, 64, "<i4"), cospi), "cospi"
    img.find([0, 1321, 2482, 3344, 3803], "<i4")
    other.append(("cospi", cospi, "int32_t"))
    # the in-loop filters after deblocking: dav1d's self-guided parameters
    # (s0, s1 of each set; the radii follow from the zeros), its 1 / x table
    # (checked against the specification's a2), the CDEF directions (offsets
    # in a 12-wide buffer) and the upscaling filter (stored negated)
    sgr = img.read(img.find([140, 3236, 112, 2158, 93, 1618], "<u2"), 32, "<u2").reshape(16, 2)
    assert sgr[14, 1] == 0 and sgr[10, 0] == 0
    other.append(("sgr_params", sgr, "uint16_t"))
    z = np.arange(256)
    a2 = np.where(z >= 255, 256, np.where(z == 0, 1, ((z << 8) + z // 2) // (z + 1)))
    x_by_x = img.read(img.find([255, 128, 85, 64, 51, 43, 37, 32], "<u1"), 256, "<u1")
    assert np.array_equal(x_by_x, 256 - a2), "sgr x_by_x"
    dirs = [[(-1, 1), (-2, 2)], [(0, 1), (-1, 2)], [(0, 1), (0, 2)], [(0, 1), (1, 2)],
            [(1, 1), (2, 2)], [(1, 0), (2, 1)], [(1, 0), (2, 0)], [(1, 0), (2, -1)]]
    img.find([r * 12 + c for d in dirs for r, c in d], "<i1")
    other.append(("cdef_directions", np.array(dirs, np.int8), "int8_t"))
    rf = -img.read(img.find([0, 0, 0, -128, 0, 0, 0, 0, 0, 0, 1, -128, -2, 1, 0, 0], "<i1"),
                   512, "<i1").astype(np.int16).reshape(64, 8)
    assert np.all(rf.sum(1) == 128) and rf[32, 3] == 79
    other.append(("upscale_filter", rf.astype(np.int8), "int8_t"))

    # film grain: dav1d's 2048-entry Gaussian sequence (the specification's
    # Gaussian_Sequence: multiples of 4 in [-2048, 2047])
    gauss = img.read(img.find([56, 568, -180, 172, 124, -84, 172, -64, -900, 24, 820, 224],
                              "<i2"), 2048, "<i2")
    assert np.all(gauss % 4 == 0) and gauss.min() >= -2048 and gauss.max() < 2048
    assert list(gauss[-3:]) == [944, 428, -484]
    other.append(("gaussian_sequence", gauss, "int16_t"))

    lines = ["// Generated by scripts/make_av1_tables.py: AV1's default CDFs and constant",
             "// tables, read out of dav1d 1.5.1 and aom 3.12.1 as linked into PIL 12.1's",
             "// libavif. CDFs are stored as 32768 - cdf, each followed by 0 and a zero count.",
             "#pragma once", "#include <cstdint>", "namespace av1t {", ""]
    for name, arr, _ in tabs:
        lines.append(fmt(name, arr, "uint16_t"))
    for name, arr in mv:
        lines.append(fmt(name, arr, "uint16_t"))
    for name, arr, ctype in other:
        lines.append(fmt(name, arr, ctype))
    lines.append("}  // namespace av1t\n")
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {args.out}: {len(tabs) + len(mv)} CDF tables, {len(other)} others")


if __name__ == "__main__":
    main()
