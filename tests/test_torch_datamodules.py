"""The port's file-backed datamodules against the JAX package's, on fixture
trees of 24x24 images the test writes for every registered name (as
tests/test_data_fixtures.py does for a few): both factories give the same
class names and prompts, the same samples in order for train, val and
test (pixels `np.array_equal`, texts, class and image ids, image paths)
and the same first batch of each loader, plain, with a subset and with
few-shot sampling. `datasets.load_dataset` is monkeypatched to in-memory
`DatasetDict`s (cifar100, imagenet-sketch). Also: the sklearn-free split
against sklearn, the few-shot RNG quirk, and the corruption and revert
transforms bit-equal to JAX.
"""

import csv
import io
import json
import tarfile

import datasets
import numpy as np
import pandas as pd
import pytest
import scipy.io
from PIL import Image
from sklearn.model_selection import train_test_split as sk_train_test_split

from bayesvlm_tpu.data import transforms as jax_transforms
from bayesvlm_tpu.data.factory import SUPPORTED_MODULES as JAX_MODULES
from bayesvlm_tpu.data.factory import DataModuleFactory as JaxFactory
from bayesvlm_tpu_torch.data import transforms
from bayesvlm_tpu_torch.data.base import few_shot_positions, train_test_split
from bayesvlm_tpu_torch.data.factory import SUPPORTED_MODULES, DataModuleFactory

SIZE = 16  # the transforms' output size
WNIDS = ["n01443537", "n01484850", "n01494475"]
ITERABLE = ("laion400m", "imagenet-val-wds")  # no map-style datasets
# modules that take no subset, in both packages: the whole train split
NO_SUBSET = ("synthetic", "imagenet-50", "imagenet-100", "imagenet-sketch")
FEW_SHOT = ("food101", "dtd", "flowers102", "stanfordcars", "eurosat", "sun397",
            "ucf101", "oxfordpets", "cub")


def _jpg(path, seed: int):
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, size=(24, 24, 3), dtype=np.uint8), "RGB").save(path)


def _jpg_bytes(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, size=(24, 24, 3), dtype=np.uint8), "RGB").save(
        buf, format="JPEG")
    return buf.getvalue()


def _tar(path, members):
    path.parent.mkdir(parents=True, exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def _write_tree(root):
    """DATA_BASE_DIR with every registered dataset's on-disk layout."""
    seed = iter(range(10_000))
    # food101: meta/{train,test}.json (class -> stems), images/<stem>.jpg
    food = root / "food101" / "food-101"
    meta = {"train": {}, "test": {}}
    for split, n in (("train", 7), ("test", 2)):
        for cls in ("waffles", "apple_pie", "ramen"):
            meta[split][cls] = [f"{cls}/{split}{i}" for i in range(n)]
            for stem in meta[split][cls]:
                _jpg(food / "images" / f"{stem}.jpg", next(seed))
    (food / "meta").mkdir(parents=True)
    for split in meta:
        (food / "meta" / f"{split}.json").write_text(json.dumps(meta[split]))
    # dtd: labels/{train,val,test}1.txt, images/<class>/<file>
    dtd = root / "dtd" / "dtd"
    (dtd / "labels").mkdir(parents=True)
    for split, n in (("train", 5), ("val", 2), ("test", 2)):
        lines = [f"{cls}/{cls}_{split}{i}.jpg" for cls in ("banded", "woven_x") for i in range(n)]
        for line in lines:
            _jpg(dtd / "images" / line, next(seed))
        (dtd / "labels" / f"{split}1.txt").write_text("\n".join(lines) + "\n")
    # flowers102: jpg/image_%05d.jpg, setid.mat, imagelabels.mat
    fl = root / "flowers102" / "flowers-102"
    labels = np.array([1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 102, 102, 5, 5], np.uint8)
    for i in range(1, len(labels) + 1):
        _jpg(fl / "jpg" / f"image_{i:05d}.jpg", next(seed))
    scipy.io.savemat(fl / "imagelabels.mat", {"labels": labels[None]})
    scipy.io.savemat(fl / "setid.mat", {
        "trnid": np.array([[1, 2, 3, 4, 5, 6, 13, 15, 16, 14]]),
        "valid": np.array([[7, 8]]), "tstid": np.array([[9, 10, 11, 12]])})
    # stanfordcars (DATASET_SUBDIR ""): devkit .mat lists, cars_{train,test}/
    cars = root / "stanford_cars"
    (cars / "devkit").mkdir(parents=True)
    names = np.array(["AM General Hummer SUV 2000", "Acura RL Sedan 2012", "Audi R8 2012"],
                     dtype=object)
    scipy.io.savemat(cars / "devkit" / "cars_meta.mat", {"class_names": names[None]})
    for split, annos_path, n in (("train", cars / "devkit" / "cars_train_annos.mat", 9),
                                 ("test", cars / "cars_test_annos_withlabels.mat", 4)):
        annos = np.zeros((1, n), dtype=[("fname", "O"), ("class", "O")])
        for i in range(n):
            fname = f"{i:05d}.jpg"
            annos[0, i] = (fname, np.array([[i % 3 + 1]], np.uint8))
            _jpg(cars / f"cars_{split}" / fname, next(seed))
        scipy.io.savemat(annos_path, {"annotations": annos})
    # the zhou-split modules: split JSON + image subdir
    for sub, split_file, image_sub in (
            ("eurosat", "split_zhou_EuroSAT.json", "2750"),
            ("sun397", "split_zhou_SUN397.json", "SUN397"),
            ("ucf101", "split_zhou_UCF101.json", "UCF-101-midframes"),
            ("oxfordpets", "split_zhou_OxfordPets.json", "images"),
            ("cub", "split_CUB.json", "images")):
        split = {"train": [], "val": [], "test": []}
        for ci, cls in enumerate(("Annual_Crop", "Forest", "river_bank")):
            for i in range(7):
                rel = f"{cls}/{cls}_{i}.jpg"
                _jpg(root / sub / image_sub / rel, next(seed))
                bucket = ("train", "train", "train", "train", "train", "val", "test")[i]
                split[bucket].append([rel, ci, cls])
        (root / sub / split_file).write_text(json.dumps(split))
    # homeoffice: <domain>/<class>/*.jpg
    for domain in ("Art", "Clipart", "Product", "Real World"):
        for cls in ("Alarm_Clock", "Bike", "Chair"):
            for i in range(4):
                _jpg(root / "homeoffice" / domain / cls / f"{i:05d}.jpg", next(seed))
    # imagenet: class names, the wds shards, the parquet files, folder trees
    (root / "imagenet_classes.json").write_text(json.dumps(
        [f"imagenet class {i}" for i in range(1000)]))
    for s, n in enumerate((5, 4)):
        members = []
        for i in range(n):
            key = f"{s}{i:04d}"
            members.append((f"{key}.jpg", _jpg_bytes(next(seed))))
            if (s, i) != (0, 2):  # one sample without a label: skipped
                members.append((f"{key}.cls", str((7 * s + 3 * i) % 1000).encode()))
        _tar(root / "imagenet_val_wds" / f"{s:05d}.tar", members)
    chosen = np.sort(np.random.RandomState(0).choice(np.arange(1000), 50, replace=False))
    (root / "imagenet_1k").mkdir()
    for name, n in (("trainval", 12), ("test", 5)):
        # three of the classes both subsets pick, and one they may not
        cls = [int(chosen[i % 3]) if i % 4 else 999 - int(chosen[0]) for i in range(n)]
        pd.DataFrame({"jpg": [_jpg_bytes(next(seed)) for _ in range(n)], "cls": cls}
                     ).to_parquet(root / "imagenet_1k" / f"{name}.parquet")
    for tree in (root / "imagenet-r", root / "imagenet_variations" / "renditions",
                 root / "imagenet_variations" / "sketch"):
        for wnid in WNIDS:
            for i in range(5):
                _jpg(tree / wnid / f"{wnid}_{i}.jpg", next(seed))
        (tree / "notes.txt").write_text("not a class")
    for d in (root / "imagenet-r", root / "imagenet_variations"):
        with open(d / "classes.csv", "w", newline="") as f:
            csv.writer(f).writerows([[w, f"words for {w}"] for w in WNIDS[:2]])
    # laion400m: jpg + txt pairs
    for s, n in enumerate((5, 3)):
        members = []
        for i in range(n):
            key = f"{s * 100 + i:09d}"
            members += [(f"{key}.jpg", _jpg_bytes(next(seed))),
                        (f"{key}.txt", f"a photo number {key}".encode())]
        _tar(root / "laion400m" / f"{s:05d}.tar", members)
    return root


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("datasets"))


@pytest.fixture(scope="module")
def hf_dicts():
    """In-memory stand-ins of the two HF datasets the registry loads."""
    rng = np.random.default_rng(5)

    def images(n):
        return [Image.fromarray(rng.integers(0, 255, size=(24, 24, 3), dtype=np.uint8), "RGB")
                for _ in range(n)]

    def split(n, image_key, label_key, names):
        feats = datasets.Features({image_key: datasets.Image(),
                                   label_key: datasets.ClassLabel(names=names)})
        return datasets.Dataset.from_dict(
            {image_key: images(n), label_key: [i % len(names) for i in range(n)]},
            features=feats)

    cifar_names = ["apple", "aquarium_fish", "baby", "bear"]
    sketch_names = ["tench", "goldfish", "great white shark"]
    return {"cifar100": datasets.DatasetDict(
                train=split(15, "img", "fine_label", cifar_names),
                test=split(6, "img", "fine_label", cifar_names)),
            "songweig/imagenet_sketch": datasets.DatasetDict(
                train=split(16, "image", "label", sketch_names))}


@pytest.fixture()
def hf_offline(hf_dicts, monkeypatch):
    monkeypatch.setattr(datasets, "load_dataset",
                        lambda name, cache_dir=None, **kw: hf_dicts[name])


def _factories(root, **options):
    kw = dict(batch_size=4, num_workers=1, base_path=str(root), **options)
    return (DataModuleFactory(train_transform=transforms.default_transform(SIZE),
                              test_transform=transforms.default_transform(SIZE), **kw),
            JaxFactory(train_transform=jax_transforms.default_transform(SIZE),
                       test_transform=jax_transforms.default_transform(SIZE), **kw))


def _create(factory, name: str):
    # the synthetic module draws normalised pixels of its own size
    return factory.create(name, **({"image_size": SIZE} if name == "synthetic" else {}))


def _assert_samples_equal(a: dict, b: dict, where: str):
    assert set(a) == set(b), where
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert np.array_equal(a[k], b[k]), (where, k)
        else:
            assert a[k] == b[k], (where, k)


def _assert_same_module(ours, theirs, name: str):
    assert ours.data_dir == theirs.data_dir
    assert type(ours).DATASET_SUBDIR == type(theirs).DATASET_SUBDIR
    assert ours.class_names == theirs.class_names and ours.class_prompts == theirs.class_prompts
    if name not in ITERABLE:
        for split in ("train", "val", "test"):
            a, b = getattr(ours, f"{split}_dataset"), getattr(theirs, f"{split}_dataset")
            assert len(a) == len(b), (name, split)
            if hasattr(b, "records"):
                assert a.records == b.records, (name, split)
            for i in range(len(a)):
                _assert_samples_equal(a[i], b[i], f"{name} {split}[{i}]")
    for split in ("train", "val", "test"):
        a = next(iter(getattr(ours, f"{split}_dataloader")()))
        b = next(iter(getattr(theirs, f"{split}_dataloader")()))
        _assert_samples_equal(a, b, f"{name} first {split} batch")
        assert a["image"].shape[1:] == (SIZE, SIZE, 3), name


def test_registry_is_the_jax_registry():
    assert list(SUPPORTED_MODULES) == list(JAX_MODULES) and len(SUPPORTED_MODULES) == 27
    for name, cls in SUPPORTED_MODULES.items():
        assert cls.DATASET_SUBDIR == JAX_MODULES[name].DATASET_SUBDIR, name


@pytest.mark.parametrize("name", list(SUPPORTED_MODULES))
def test_module_matches_jax(name, data_root, hf_offline):
    ours, theirs = (_create(f, name) for f in _factories(data_root))
    ours.setup()
    theirs.setup()
    assert len(ours.class_names) > 0 or name == "laion400m"
    _assert_same_module(ours, theirs, name)


@pytest.mark.parametrize("option", ["subset", "few_shot"])
@pytest.mark.parametrize("name", list(SUPPORTED_MODULES))
def test_module_options_match_jax(name, option, data_root, hf_offline):
    """A subset (positions 3, 0, 2 of the train split) or few-shot draws
    (2 a class, seed 7): the same samples as JAX, or the same refusal."""
    options = (dict(subset_indices=[3, 0, 2]) if option == "subset" else
               dict(use_few_shot=True, shots_per_class=2, few_shot_sample_seed=7))
    ours_f, theirs_f = _factories(data_root, **options)
    try:
        theirs = _create(theirs_f, name)
        theirs.setup()
    except ValueError as e:  # the webdataset modules refuse both options
        assert name in ITERABLE
        with pytest.raises(ValueError, match=str(e)):
            _create(ours_f, name).setup()
        return
    ours = _create(ours_f, name)
    ours.setup()
    _assert_same_module(ours, theirs, name)
    if option == "subset" and name not in NO_SUBSET:
        assert len(ours.train_dataset) == 3
    if option == "few_shot" and name in FEW_SHOT:
        ids = [ours.train_dataset[i]["class_id"] for i in range(len(ours.train_dataset))]
        assert ids and all(ids.count(c) == 2 for c in ids), (name, ids)


def test_few_shot_resets_the_seed_for_every_class():
    """Two classes of the same size pick the same positions within them
    (the reference's quirk), and the draw is np.random.seed + choice's."""
    labels = ["b", "a", "b", "a", "b", "a", "b", "a", "c", "c"]
    got = few_shot_positions(labels, 2, seed=3)
    by = {c: [i for i, x in enumerate(labels) if x == c] for c in "bac"}
    pos = {c: [by[c].index(i) for i in got if labels[i] == c] for c in "bac"}
    assert pos["b"] == pos["a"] and len(got) == 6
    np.random.seed(3)
    assert pos["b"] == list(np.random.choice(4, 2, replace=False))


def test_food101_split_is_sklearns(data_root):
    """The train/val split of Food101 is sklearn's train_test_split(
    indices, test_size=0.2, random_state=0), and so is the sklearn-free
    helper at other lengths."""
    for n in (2, 3, 5, 10, 21, 99, 101, 1000, 75750):
        items = list(range(n))
        theirs = sk_train_test_split(items, test_size=0.2, random_state=0)
        assert list(train_test_split(items, test_size=0.2, random_state=0)) == [
            list(x) for x in theirs], n
    ours, _ = _factories(data_root)
    dm = ours.create("food101")
    train, val, _, _ = dm._load_records()
    all_train = train + val
    by_id = sorted(all_train, key=lambda r: r[2])
    idx_train, idx_val = sk_train_test_split(list(range(len(by_id))), test_size=0.2,
                                             random_state=0)
    assert train == [by_id[i] for i in idx_train] and val == [by_id[i] for i in idx_val]


@pytest.mark.parametrize("std", [0.1, 0.5])
def test_corruption_and_revert_transforms_match_jax(std):
    rng = np.random.default_rng(11)
    img = Image.fromarray(rng.integers(0, 255, size=(30, 20, 3), dtype=np.uint8), "RGB")
    ours = transforms.corruption_transform(SIZE, std, seed=4)(img)
    theirs = jax_transforms.corruption_transform(SIZE, std, seed=4)(img)
    assert ours.dtype == np.float32 and np.array_equal(ours, theirs)
    # content-keyed noise: the same image twice, the same draw; another seed, not
    assert np.array_equal(ours, transforms.corruption_transform(SIZE, std, seed=4)(img))
    assert not np.array_equal(ours, transforms.corruption_transform(SIZE, std, seed=5)(img))
    for ours_f, theirs_f in ((transforms.revert_normalization,
                              jax_transforms.revert_normalization),
                             (transforms.revert_siglip_normalization,
                              jax_transforms.revert_siglip_normalization)):
        assert np.array_equal(ours_f(ours), theirs_f(theirs))
    # the CLIP transform, reverted: the cropped pixels in [0, 1]
    clean = transforms.default_transform(SIZE)(img)
    crop = transforms._center_crop(transforms._resize_shorter(img, SIZE), SIZE)
    np.testing.assert_allclose(transforms.revert_normalization(clean),
                               np.asarray(crop, np.float32) / 255.0, atol=1e-6)
