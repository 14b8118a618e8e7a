"""The port's native decode lane (bayesvlm_tpu_torch/data/native_io.py and
the loader over it in data/wds.py) against the JAX package's on the CPU:
the tar index, the CPU decode lane (libjpeg + `resize_crop_reference`) on
every fixture of tests/torch_jpeg/ in both modes and both families
(statuses equal, uint8 and fp32 bit for bit), `NativeDecodeLoader` over a
tar the test writes, and the committed goldens against the JAX lane; the
plain colour stage on libjpeg's planes against libjpeg's RGB.

The JAX reference library is `native/bvt_io.cc` compiled by g++ into a
directory of this module's own (never `make -C native`, which the JAX
tests run), loaded by pointing `bayesvlm_tpu.data.native_io` there. The
`cuda`-marked tests hold the card's lane (nvJPEG, the ycc_to_rgb and
resize_crop kernels) to the plain versions and the goldens; they skip
without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_native_io.py
"""

import io
import shutil
import sys
import tarfile
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch import kernels
from bayesvlm_tpu_torch.data import native_io
from bayesvlm_tpu_torch.data.wds import NativeDecodeLoader, WebDataset

FIXTURE_DIR = Path(__file__).resolve().parent / "torch_jpeg"
sys.path.insert(0, str(FIXTURE_DIR))
import make_fixtures as mf  # noqa: E402

NAMES = list(mf.FIXTURES)
# (size, square_resize, mean, std): CLIP's crop and SigLIP's square resize
# at their widths, and a small and a large size of each mode
MODES = {"clip224": (224, False, mf.CLIP_MEAN, mf.CLIP_STD),
         "siglip256": (256, True, mf.SIGLIP_MEAN, mf.SIGLIP_STD),
         "crop7": (7, False, mf.CLIP_MEAN, mf.CLIP_STD),
         "crop600": (600, False, mf.SIGLIP_MEAN, mf.SIGLIP_STD),
         "square1": (1, True, mf.CLIP_MEAN, mf.CLIP_STD)}


def _have_jpeglib() -> bool:
    return any(Path(d, "jpeglib.h").exists() for d in ("/usr/include", "/usr/local/include"))


@pytest.fixture(scope="module")
def jio(tmp_path_factory):
    """`bayesvlm_tpu.data.native_io` on the JAX library built here."""
    if shutil.which("g++") is None or not _have_jpeglib():
        pytest.skip("the JAX reference library needs g++ and libjpeg's jpeglib.h")
    from bayesvlm_tpu.data import native_io as jax_native_io

    lib = mf.build_jax_reference(tmp_path_factory.mktemp("jax_native"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_io, "_LIB_PATH", lib)
        mp.setattr(jax_native_io, "_lib", None)
        yield jax_native_io


@pytest.fixture(scope="module")
def jpegs():
    return [(FIXTURE_DIR / n).read_bytes() for n in NAMES]


@pytest.fixture(scope="module")
def goldens():
    return dict(np.load(FIXTURE_DIR / "goldens.npz"))


def _add(tf, name, data, **info_kw):
    info = tarfile.TarInfo(name=name)
    info.size = len(data)
    for k, v in info_kw.items():
        setattr(info, k, v)
    tf.addfile(info, io.BytesIO(data))


# -- the tar reader ---------------------------------------------------------------


@pytest.mark.parametrize("fmt", [tarfile.USTAR_FORMAT, tarfile.GNU_FORMAT,
                                 tarfile.PAX_FORMAT])
def test_tar_index_matches_jax(jio, tmp_path, fmt):
    """Entries and members as JAX's reader gives them: a name past 100
    characters split into the ustar prefix (joined only under the POSIX
    magic), a directory and a link skipped, members read back by pread.
    The same name in a GNU 'L' or a pax 'path' member is read whole, as
    tarfile reads it, where JAX's reader keeps the 100-byte field."""
    deep = "/".join(["d" * 38] * 4)  # a 155-character prefix, the longest
    longname = deep + "/" + "f" * 96 + ".txt"  # 256 characters in all
    path = tmp_path / "x.tar"
    with tarfile.open(path, "w", format=fmt) as tf:
        _add(tf, "000000001.jpg", b"\xff\xd8 one")
        _add(tf, "000000001.txt", b"caption one")
        _add(tf, "dir", b"", type=tarfile.DIRTYPE)
        _add(tf, "link.txt", b"", type=tarfile.SYMTYPE, linkname="000000001.txt")
        _add(tf, "000000002.cls", b"7")
        _add(tf, longname, b"deep payload")
        _add(tf, "000000003.txt", b"after the long name")
    ours, theirs = native_io.tar_index(path), jio.tar_index(path)
    with tarfile.open(path) as tf:
        members = [(m.name, m.offset_data, m.size) for m in tf if m.isfile()]
    assert ours == members
    if fmt == tarfile.USTAR_FORMAT:
        assert ours == theirs
    else:  # JAX's reader: the long name's header field, the rest the same
        assert [e for e in theirs if e[0] != longname[:100]] == [
            e for e in ours if e[0] != longname]
        assert (longname[:100], *ours[-2][1:]) in theirs
    assert ours[:2] == [("000000001.jpg", 512, 6), ("000000001.txt", 1536, 11)]
    assert ours[-2][0] == longname
    for name, offset, size in ours:
        assert native_io.read_member(path, offset, size) == (
            b"deep payload" if name == longname else jio.read_member(path, offset, size))
    with pytest.raises(IOError, match="cannot index"):
        native_io.tar_index(tmp_path / "missing.tar")
    with pytest.raises(IOError, match="pread failed"):
        native_io.read_member(path, 10**9, 4)


def test_webdataset_native_reader_matches_tarfile(tmp_path):
    """`use_native=True` and `False` yield the same samples, in every tar
    format, long names included; the default is tarfile whatever is built,
    so a sample's key never depends on the build directory."""
    native_io.prepare("cpu")
    deep = "/".join(["d" * 38] * 4) + "/" + "k" * 95  # a 250-character key
    for fmt in (tarfile.USTAR_FORMAT, tarfile.GNU_FORMAT, tarfile.PAX_FORMAT):
        path = tmp_path / f"s{fmt}.tar"
        with tarfile.open(path, "w", format=fmt) as tf:
            for i in range(3):
                _add(tf, f"{i:09d}.jpg", bytes([i]) * (100 + i))
                _add(tf, f"{i:09d}.json", b'{"k": %d}' % i)
            _add(tf, "noext", b"x")
            _add(tf, deep + ".jpg", b"long")
            _add(tf, deep + ".json", b'{"k": 3}')
        native = list(WebDataset([path], use_native=True))
        assert native == list(WebDataset([path], use_native=False))
        assert [s["json"]["k"] for s in native] == [0, 1, 2, 3]
        assert native[-1]["__key__"] == "k" * 95
    assert native_io.available() and not WebDataset([path]).use_native
    assert WebDataset([path, path], use_native=True).shard_slice(0, 2).use_native


# -- the CPU decode lane against the JAX lane ----------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("u8", [True, False], ids=["u8", "fp32"])
def test_decode_batch_matches_jax_bit_for_bit(jio, jpegs, mode, u8):
    size, square, mean, std = MODES[mode]
    if u8:
        theirs, jst = jio.decode_batch_u8(jpegs, size, square_resize=square, num_threads=3)
        ours, st = native_io.decode_batch_u8(jpegs, size, square_resize=square,
                                             num_threads=3, device="cpu")
    else:
        theirs, jst = jio.decode_batch(jpegs, size, mean, std, square_resize=square,
                                       num_threads=3)
        ours, st = native_io.decode_batch(jpegs, size, mean, std, square_resize=square,
                                          num_threads=3, device="cpu")
    assert st.dtype == np.int32 and st.tolist() == jst.tolist()
    assert st.tolist() == [0] * 9 + [-1, -1]  # CMYK and not-a-JPEG fail
    assert ours.device.type == "cpu" and ours.dtype == (torch.uint8 if u8 else torch.float32)
    assert ours.shape == (len(jpegs), size, size, 3)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert not ours[st != 0].any()  # a failed image is all zeros


def test_resize_crop_reference_matches_jax_on_the_same_decode(jio, jpegs):
    """libjpeg's RGB from the port's decoder is the JAX decoder's (a
    same-size square resize returns the source itself), and the plain
    version on it gives the JAX lane's crops; `resize_crop` on CPU tensors
    is the plain version."""
    rgbs, st = native_io.decode_rgb(jpegs, "cpu", num_threads=2)
    assert [r is None for r in rgbs] == [s != 0 for s in st]
    for name in mf.SQUARE_FIXTURES:
        r = rgbs[NAMES.index(name)]
        same, _ = jio.decode_batch_u8([jpegs[NAMES.index(name)]], r.shape[1],
                                      square_resize=True, num_threads=1)
        np.testing.assert_array_equal(r.numpy(), same[0])
    for size, square, mean, std in MODES.values():
        for u8 in (True, False):
            ref = native_io.resize_crop_reference(rgbs, size, square, mean, std, u8)
            if u8:
                theirs, _ = jio.decode_batch_u8(jpegs, size, square_resize=square)
            else:
                theirs, _ = jio.decode_batch(jpegs, size, mean, std, square_resize=square)
            np.testing.assert_array_equal(ref.numpy(), theirs)
            assert torch.equal(native_io.resize_crop(rgbs, size, square, mean, std, u8),
                               ref)
    assert native_io.resize_crop([None, None], 5).shape == (2, 5, 5, 3)
    with pytest.raises(ValueError, match="uint8"):
        native_io.resize_crop([rgbs[0].float()], 5)


def test_colour_stage_reference_is_libjpegs(jpegs):
    """The plain colour stage (chroma upsampling and YCbCr -> RGB) on
    libjpeg's own planes (raw data, before its colour stage) gives
    libjpeg's RGB bit for bit on every fixture: 4:2:0, 4:2:2, 4:4:4,
    progressive, grey, odd sizes, strips one sample wide (replication) and
    the half-cut image; the statuses are the RGB decode's."""
    if shutil.which("g++") is None or not _have_jpeglib():
        pytest.skip("the CPU lane needs g++ and libjpeg's jpeglib.h")
    planes, st = native_io.decode_planes(jpegs, "cpu", num_threads=3)
    rgbs, rst = native_io.decode_rgb(jpegs, "cpu", num_threads=3)
    assert st.tolist() == rst.tolist() == [0] * 9 + [-1, -1]
    factors = {n: (p.hf, p.vf) for n, p in zip(NAMES, planes) if p is not None}
    assert factors["smooth_420.jpg"] == (2, 2) and factors["smooth_422.jpg"] == (2, 1)
    assert factors["smooth_444.jpg"] == (1, 1) and factors["grey.jpg"] == (0, 0)
    ours = native_io.ycc_to_rgb(planes)
    for name, p, mine, theirs in zip(NAMES, planes, ours, rgbs):
        assert (p is None) == (mine is None) == (theirs is None), name
        if p is not None:
            assert mine.dtype == torch.uint8 and torch.equal(mine, theirs), name
    assert native_io.ycc_to_rgb([None]) == [None]


def test_goldens_equal_the_jax_lane(jio, jpegs, goldens):
    """The committed goldens are the JAX lane's output on the committed
    fixtures, and the port's CPU lane gives them."""
    fresh = mf.goldens(jio, jpegs)
    assert sorted(fresh) == sorted(goldens)
    for key, value in fresh.items():
        np.testing.assert_array_equal(value, goldens[key], err_msg=key)
    u8, st = native_io.decode_batch_u8(jpegs, mf.CROP, device="cpu")
    np.testing.assert_array_equal(u8.numpy(), goldens["u8_crop224"])
    np.testing.assert_array_equal(st, goldens["status"])
    sq, _ = native_io.decode_batch_u8(jpegs, mf.SQUARE, square_resize=True, device="cpu")
    assert mf.sha(sq.numpy()) == str(goldens["sha_u8_square256"])
    f32, _ = native_io.decode_batch(jpegs, mf.CROP, mf.CLIP_MEAN, mf.CLIP_STD, device="cpu")
    assert mf.sha(f32.numpy()) == str(goldens["sha_fp32_crop224"])
    f32, _ = native_io.decode_batch(jpegs, mf.SQUARE, mf.SIGLIP_MEAN, mf.SIGLIP_STD,
                                    square_resize=True, device="cpu")
    assert mf.sha(f32.numpy()) == str(goldens["sha_fp32_square256"])


def test_card_lane_raises_without_a_card(jpegs):
    """`device="cuda"` never drops to the CPU: without a card it raises
    before decoding anything."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for call in (lambda: native_io.decode_batch_u8(jpegs, 32),
                 lambda: native_io.decode_batch(jpegs, 32, mf.CLIP_MEAN, mf.CLIP_STD),
                 lambda: native_io.prepare("cuda"),
                 lambda: iter(NativeDecodeLoader([], 2, 32, mf.CLIP_MEAN, mf.CLIP_STD))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not native_io.build("cuda")
    with pytest.raises(ValueError, match="no native decode lane"):
        native_io.decode_batch_u8(jpegs, 32, device="meta")


def test_host_build_names_a_missing_jpeglib(monkeypatch, tmp_path):
    """A host source that cannot find its header is refused with that
    reason (the card's machine has no libjpeg)."""
    src = tmp_path / "needs_jpeg.cc"
    src.write_text("#include <no_such_dir/jpeglib.h>\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        kernels.build_host("needs_jpeg")
    assert kernels.link_flags(FIXTURE_DIR.parent.parent / "bayesvlm_tpu_torch" / "csrc"
                              / "jpeg_decode.cu") == ("-lnvjpeg",)
    assert kernels.link_flags(src) == ()


# -- the loader -------------------------------------------------------------------------


def _loader_tar(path):
    """Samples with integer and non-integer keys, .jpg and .jpeg members,
    captions and classes, a corrupt JPEG and a sample without an image."""
    fixtures = {n: (FIXTURE_DIR / n).read_bytes() for n in NAMES}
    members = []
    for i, name in enumerate(["smooth_420.jpg", "noise.jpg", "cmyk.jpg", "grey.jpg",
                              "progressive.jpg", "not_jpeg.jpg", "strip_500x1.jpg",
                              "smooth_444.jpg", "truncated.jpg", "smooth_422.jpg"]):
        key = f"{i:09d}" if i != 4 else "n01440764_10026"
        ext = "jpeg" if i in (3, 7) else "jpg"
        members += [(f"{key}.{ext}", fixtures[name]),
                    (f"{key}.txt", f"caption {i}".encode()),
                    (f"{key}.cls", str(i % 3).encode())]
    members += [("000000099.txt", b"no image")]
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            _add(tf, name, data)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("u8", [True, False], ids=["u8", "fp32"])
def test_native_decode_loader_matches_jax(jio, tmp_path, drop_last, u8):
    from bayesvlm_tpu.data.wds import NativeDecodeLoader as JaxLoader
    from bayesvlm_tpu.data.wds import WebDataset as JaxWebDataset

    path = tmp_path / "mixed.tar"
    _loader_tar(path)
    kw = dict(batch_size=4, image_size=32, mean=mf.CLIP_MEAN, std=mf.CLIP_STD,
              drop_last=drop_last, num_threads=2, out_uint8=u8)
    with warnings.catch_warnings(record=True) as ours_w:
        warnings.simplefilter("always")
        ours = list(NativeDecodeLoader(WebDataset([path], use_native=True), device="cpu",
                                       **kw))
    with warnings.catch_warnings(record=True) as theirs_w:
        warnings.simplefilter("always")
        theirs = list(JaxLoader(JaxWebDataset([path], use_native=True), **kw))
    assert sorted(map(str, (w.message for w in ours_w))) == sorted(
        map(str, (w.message for w in theirs_w)))
    assert len(ours) == len(theirs) == (2 if drop_last else 3)
    # batch 1 drops the CMYK image (3 of 4); batch 2 not_jpeg (3 of 4)
    assert [len(b["image_id"]) for b in ours] == [3, 3, 2][:len(ours)]
    for ob, tb in zip(ours, theirs):
        assert ob.keys() == tb.keys() == {"image", "text", "image_id", "class_id"}
        assert isinstance(ob["image"], torch.Tensor)
        np.testing.assert_array_equal(ob["image"].numpy(), tb["image"])
        np.testing.assert_array_equal(ob["image_id"], tb["image_id"])
        np.testing.assert_array_equal(ob["class_id"], tb["class_id"])
        assert ob["text"] == tb["text"]
    assert zlib.crc32(b"n01440764_10026") in ours[1]["image_id"]


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nvJPEG and the lane's kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_resize_crop_kernel_matches_plain_on_card(cuda, jpegs, mode):
    """The kernel equals its plain version bit for bit on the same nvJPEG
    RGB, uint8 and fp32, and the statuses are the goldens'."""
    size, square, mean, std = MODES[mode]
    rgbs, st = native_io.decode_rgb(jpegs, cuda)
    np.testing.assert_array_equal(st, np.load(FIXTURE_DIR / "goldens.npz")["status"])
    for u8 in (True, False):
        before = native_io.resize_crop.launches
        out = native_io.resize_crop(rgbs, size, square, mean, std, u8)
        ref = native_io.resize_crop_reference(rgbs, size, square, mean, std, u8)
        torch.cuda.synchronize()
        assert native_io.resize_crop.launches == before + 1
        assert out.is_cuda and torch.equal(out, ref)


@pytest.mark.cuda
def test_ycc_to_rgb_kernel_matches_plain_on_card(cuda, jpegs):
    """The colour stage's kernel equals its plain version bit for bit on
    the same nvJPEG planes, with one launch, and the statuses are the
    goldens'."""
    planes, st = native_io.decode_planes(jpegs, cuda)
    np.testing.assert_array_equal(st, np.load(FIXTURE_DIR / "goldens.npz")["status"])
    before = native_io.ycc_to_rgb.launches
    out = native_io.ycc_to_rgb(planes)
    ref = native_io.ycc_to_rgb_reference(planes)
    torch.cuda.synchronize()
    assert native_io.ycc_to_rgb.launches == before + 1
    for mine, theirs in zip(out, ref):
        assert (mine is None) == (theirs is None)
        assert mine is None or (mine.is_cuda and torch.equal(mine, theirs))


@pytest.mark.cuda
def test_loader_hands_device_batches_over_on_the_consumers_stream(cuda, tmp_path):
    """Batches taken through PrefetchLoader's thread (decoded on the
    loader's stream) equal those decoded in this thread, with the same
    samples dropped as the CPU test's loader drops."""
    from bayesvlm_tpu_torch.data.prefetch import PrefetchLoader

    path = tmp_path / "mixed.tar"
    _loader_tar(path)
    kw = dict(batch_size=4, image_size=32, mean=mf.CLIP_MEAN, std=mf.CLIP_STD,
              drop_last=False, out_uint8=True, device=cuda)
    direct = list(NativeDecodeLoader(WebDataset([path]), **kw))
    handed = list(PrefetchLoader(NativeDecodeLoader(WebDataset([path]), **kw)))
    assert [len(b["image_id"]) for b in handed] == [3, 3, 2]
    for d, h in zip(direct, handed):
        assert h["image"].is_cuda and torch.equal(d["image"], h["image"])
        np.testing.assert_array_equal(d["image_id"], h["image_id"])
