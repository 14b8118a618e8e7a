"""The walker of a cut JPEG's scan (bayesvlm_tpu_torch/csrc/jpeg_scan.cc,
`native_io.scan_cut`) and the patch it drives (`native_io.patch_planes`),
held to libjpeg on the CPU.

Small images are made here with PIL: 4:2:0, 4:2:2, 4:4:4 and grey, at odd
and even sizes, without restart markers and with them (every 2 MCUs, every
MCU row), each cut at 8 or 9 places in its scan: one byte into the first
MCU, just after a restart marker, evenly over the scan, and just before
the EOI (nothing lost). On each cut stream:
  - the walker's MCU and its dequantised coefficients are libjpeg's
    (`jpeg_read_coefficients`, through the CPU lane's library): earlier
    MCUs as the whole file's, later ones all zero;
  - libjpeg's planes of the whole file, patched, are libjpeg's planes of
    the cut one, bit for bit, and so are libjpeg's planes of the repaired
    stream that the card decodes in place of a cut one with restart
    markers, patched;
  - the port's chain (those planes -> `planes_crop_reference`) and its CPU
    lane give the JAX lane's crops bit for bit.
The committed cut cases (tests/torch_jpeg/cut_goldens.npz, which the card
is held to) are the JAX lane's, and the patched chain gives them where the
walker covers the file; the complete fixtures are not walked.
"""

import io
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.data import native_io

FIXTURE_DIR = Path(__file__).resolve().parent / "torch_jpeg"
sys.path.insert(0, str(FIXTURE_DIR))
import make_fixtures as mf  # noqa: E402

SEED = 20261019
# name -> (width, height, PIL subsampling, or None for grey)
IMAGES = {"420_odd": (37, 29, 2), "422_odd": (35, 23, 1), "444_odd": (19, 13, 0),
          "grey_odd": (29, 19, None), "420_even": (48, 32, 2), "grey_even": (40, 24, None)}
RESTARTS = {"none": {}, "blocks2": dict(restart_marker_blocks=2),
            "rows1": dict(restart_marker_rows=1)}
SOURCES = [f"{i}-{r}" for i in IMAGES for r in RESTARTS]
CROPS = ((16, False), (20, True))  # (size, square_resize) of the chain


def _have_libjpeg() -> bool:
    return shutil.which("g++") is not None and any(
        Path(d, "jpeglib.h").exists() for d in ("/usr/include", "/usr/local/include"))


@pytest.fixture(scope="module", autouse=True)
def _needs_libjpeg():
    if not _have_libjpeg():
        pytest.skip("libjpeg's side of these tests needs g++ and jpeglib.h")


@pytest.fixture(scope="module")
def jio(tmp_path_factory):
    """`bayesvlm_tpu.data.native_io` on the JAX library built here."""
    from bayesvlm_tpu.data import native_io as jax_native_io

    lib = mf.build_jax_reference(tmp_path_factory.mktemp("jax_native"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_io, "_LIB_PATH", lib)
        mp.setattr(jax_native_io, "_lib", None)
        yield jax_native_io


def _source(name: str) -> bytes:
    from PIL import Image

    image, restart = name.split("-")
    w, h, sub = IMAGES[image]
    rng = np.random.default_rng([SEED, SOURCES.index(name)])
    pixels = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    img = Image.fromarray(pixels, "RGB") if sub is not None else Image.fromarray(
        pixels[..., 0], "L")
    opts = dict(quality=90, **RESTARTS[restart])
    if sub is not None:
        opts["subsampling"] = sub
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **opts)
    return buf.getvalue()


def _offsets(data: bytes) -> list:
    start = mf.scan_start(data)
    offsets = {start + 1, len(data) - 2, *np.linspace(start + 2, len(data) - 3, 6).astype(int)}
    if any(data[k] == 0xFF and 0xD0 <= data[k + 1] <= 0xD7 for k in range(start, len(data) - 1)):
        offsets.add(mf.cut_offset(data, "after_rst"))
    return sorted(int(o) for o in offsets)


@pytest.fixture(scope="module")
def cases():
    """source name -> (whole file, [(offset, cut bytes, walk)])"""
    out = {}
    for name in SOURCES:
        data = _source(name)
        out[name] = (data, [(o, data[:o], native_io.scan_cut(data[:o])) for o in _offsets(data)])
    return out


def _mcu_of_blocks(cut, comp: int, shape) -> np.ndarray:
    """The MCU of each block of component `comp` (libjpeg's [rows, columns]
    of blocks), as the walker's grid lays them."""
    rows, cols = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
    return (rows // cut.v[comp]) * cut.mcus_per_row + cols // cut.h[comp]


@pytest.mark.parametrize("source", SOURCES)
def test_walker_finds_libjpegs_mcu_and_coefficients(cases, source):
    """Where the data ran out and that MCU's coefficients, as libjpeg reads
    the cut stream; MCUs before it as in the whole file, after it zero."""
    data, cuts = cases[source]
    whole = native_io.jpeg_coefficients(data)
    kinds = []
    for offset, cut_bytes, cut in cuts:
        theirs = native_io.jpeg_coefficients(cut_bytes)
        kinds.append(cut.kind)
        if cut.kind == native_io.CUT_COMPLETE:
            for a, b in zip(whole, theirs):
                np.testing.assert_array_equal(a, b, err_msg=f"{source} @ {offset}")
            continue
        assert cut.kind == native_io.CUT_RAN_OUT, (source, offset, cut.kind)
        assert cut.ncomp == len(theirs)
        assert cut.mcus_per_row * cut.mcu_rows > cut.mcu >= 0
        for c, (full, got) in enumerate(zip(whole, theirs)):
            mcu = _mcu_of_blocks(cut, c, got.shape[:2])
            np.testing.assert_array_equal(got[mcu < cut.mcu], full[mcu < cut.mcu])
            assert not got[mcu > cut.mcu].any(), (source, offset)
        mx, my = cut.mcu % cut.mcus_per_row, cut.mcu // cut.mcus_per_row
        for b, c in enumerate(cut.block_comp):
            by = my * cut.v[c] + cut.block_y[b]
            bx = mx * cut.h[c] + cut.block_x[b]
            if by < theirs[c].shape[0] and bx < theirs[c].shape[1]:  # not a dummy block
                np.testing.assert_array_equal(cut.coef[b], theirs[c][by, bx],
                                              err_msg=f"{source} @ {offset} block {b}")
        restart = source.split("-")[1] != "none"
        assert cut.first == (cut.first if restart else cut.mcu) <= cut.mcu
        assert (cut.repaired is not None) == restart
    assert kinds[0] == native_io.CUT_RAN_OUT and kinds[-1] == native_io.CUT_COMPLETE
    assert kinds.count(native_io.CUT_RAN_OUT) >= 6


@pytest.mark.parametrize("source", SOURCES)
def test_patched_planes_are_libjpegs_of_the_cut_stream(cases, source):
    """libjpeg's planes of the whole file, patched by the walk of a cut
    stream, equal libjpeg's planes of that stream bit for bit: the MCUs
    from the start of the one where the data ran out (of its restart
    interval, with restart markers) from the walker's IDCT, 128 after it.
    The repaired stream of a file with restart markers ends in an EOI and,
    decoded and patched, gives the same planes."""
    data, cuts = cases[source]
    for offset, cut_bytes, cut in cuts:
        theirs, cut_status = native_io.decode_planes([cut_bytes], "cpu")
        streams = [data] + ([cut.repaired] if cut.repaired is not None else [])
        for stream in streams:
            planes, status = native_io.decode_planes([stream], "cpu")
            assert status.tolist() == cut_status.tolist() == [0]
            mine = planes[0]
            native_io.patch_planes(mine, cut)
            for name in ("y", "cb", "cr"):
                a, b = getattr(mine, name), getattr(theirs[0], name)
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(a, b), f"{source} @ {offset}: plane {name}"
        if cut.repaired is not None:
            assert not native_io.cut_flags([cut.repaired])[0]
            assert native_io.scan_cut(cut.repaired).kind == native_io.CUT_COMPLETE


@pytest.mark.parametrize("source", SOURCES)
def test_patched_chain_gives_the_jax_lanes_crops(jio, cases, source):
    """The port's chain on a cut stream (the whole file's planes patched ->
    colour stage -> resize and crop, the card lane's arithmetic in plain
    PyTorch) and its CPU lane give the JAX lane's crops bit for bit."""
    data, cuts = cases[source]
    for size, square in CROPS:
        for offset, cut_bytes, cut in cuts:
            theirs, st = jio.decode_batch_u8([cut_bytes], size, square_resize=square,
                                             num_threads=1)
            planes, _ = native_io.decode_planes([data], "cpu")
            native_io.patch_planes(planes[0], cut)
            chain = native_io.planes_crop(planes, size, square, out_uint8=True)
            lane, lane_st = native_io.decode_batch_u8([cut_bytes], size, square_resize=square,
                                                      num_threads=1, device="cpu")
            assert st.tolist() == lane_st.tolist() == [0]
            np.testing.assert_array_equal(chain.numpy(), theirs,
                                          err_msg=f"{source} @ {offset}")
            np.testing.assert_array_equal(lane.numpy(), theirs)


def test_cut_goldens_are_the_jax_lanes_and_the_patched_chain_gives_them(jio):
    """cut_goldens.npz is the JAX lane's output on the committed cut cases;
    where the walker covers a case (one sequential Huffman scan) the patched
    chain (from the repaired stream the card decodes, where there are
    restart markers) gives its crop bit for bit, and the progressive,
    one-scan-a-component and arithmetic-coded cases are not covered."""
    gold = dict(np.load(mf.CUT_GOLDENS))
    sources = {n: (FIXTURE_DIR / n).read_bytes()
               for n in {*mf.CUT_SOURCES, *(s for s, _ in mf.CUT_CASES.values())}}
    cuts = mf.cut_jpegs(sources)
    fresh = mf.cut_goldens(jio, cuts)
    assert sorted(fresh) == sorted(gold)
    for key, value in fresh.items():
        np.testing.assert_array_equal(value, gold[key], err_msg=key)
    covered = []
    for i, (name, (source, offset, cut_bytes)) in enumerate(cuts.items()):
        cut = native_io.scan_cut(cut_bytes)
        if source in ("progressive.jpg", "multiscan.jpg", "arith.jpg"):
            assert cut.kind == native_io.CUT_NOT_COVERED, name
            continue
        assert cut.kind == native_io.CUT_RAN_OUT, name
        covered.append(name)
        assert (cut.repaired is not None) == source.startswith("restart"), name
        planes, _ = native_io.decode_planes([cut.repaired or sources[source]], "cpu")
        native_io.patch_planes(planes[0], cut)
        crop = native_io.planes_crop(planes, mf.CROP, out_uint8=True)
        np.testing.assert_array_equal(crop[0].numpy(), gold["u8_crop224"][i], err_msg=name)
    assert len(covered) == 8
    assert native_io.cut_flags([c[2] for c in cuts.values()]).tolist() == [
        "whole" not in name for name in cuts]


def test_only_cut_files_are_walked():
    """Every complete fixture ends in an EOI and is not walked; the half-cut
    one is, and ran out in an MCU; bytes that are not a JPEG walk to "not
    covered"; EOI followed by trailing bytes counts as complete, markers
    among them too (a phone's trailer), and a trailer with an SOS after
    its last EOI walks to complete."""
    names = [*mf.FIXTURES, *mf.CUT_SOURCES]
    jpegs = [(FIXTURE_DIR / n).read_bytes() for n in names]
    flags = dict(zip(names, native_io.cut_flags(jpegs).tolist()))
    for name, flag in flags.items():
        if name not in ("truncated.jpg", "not_jpeg.jpg"):
            assert not flag, name
    assert flags["truncated.jpg"]
    cut = native_io.scan_cut(jpegs[names.index("truncated.jpg")])
    assert cut.kind == native_io.CUT_RAN_OUT and cut.ncomp == 3
    assert (cut.h, cut.v, cut.first, cut.repaired) == ((2, 1, 1), (2, 1, 1), cut.mcu, None)
    assert native_io.scan_cut(jpegs[names.index("not_jpeg.jpg")]).kind == \
        native_io.CUT_NOT_COVERED
    smooth = jpegs[names.index("smooth_420.jpg")]
    trailer = b"\x00\x00\x00\x18ftypmp42\xff\xc0\x00\x11\xff\xe1\x12\x34\xff\xd8\xff"
    assert native_io.cut_flags([smooth + b"\x00garbage\xff", smooth[:-2], smooth + trailer,
                                smooth + trailer + b"\xff\xda\x00\x08"]).tolist() == [
        False, True, False, True]
    assert native_io.scan_cut(smooth[:-2]).kind == native_io.CUT_COMPLETE
    assert native_io.scan_cut(smooth + trailer + b"\xff\xda\x00\x08").kind == \
        native_io.CUT_COMPLETE
