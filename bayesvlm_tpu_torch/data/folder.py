"""Torchvision-layout datasets read straight from their on-disk formats
(no torchvision dependency): Food101, DTD, Flowers102, StanfordCars
(ref:bayesvlm/data/{food101,dtd,flowers102,stanfordcars}.py), the port's
copy of `bayesvlm_tpu.data.folder`.

Split parity:
  - Food101: torchvision order (meta/{split}.json insertion order), then
    sklearn's train_test_split(indices, test_size=0.2, random_state=0)
    (ref:food101.py:40-60), reproduced without sklearn
    (data/base.train_test_split);
  - DTD: partition-1 files labels/{train,val,test}1.txt (torchvision
    default), used as they are (ref:dtd.py);
  - Flowers102: setid.mat trnid/valid/tstid + imagelabels.mat (read with
    scipy.io.loadmat); class names from the public Oxford-Flowers name
    table (sorted by id);
  - StanfordCars: devkit .mat annotation lists; the reference uses the
    train split for both train and val (ref:stanfordcars.py:95-122), and
    its DATASET_SUBDIR is empty (ref:stanfordcars.py:65).
"""

from __future__ import annotations

import json

from bayesvlm_tpu_torch.data.base import DataModule, ImageRecordDataset, train_test_split

FLOWERS102_ID_TO_NAME = {
    1: "pink primrose", 2: "hard-leaved pocket orchid", 3: "canterbury bells",
    4: "sweet pea", 5: "english marigold", 6: "tiger lily", 7: "moon orchid",
    8: "bird of paradise", 9: "monkshood", 10: "globe thistle",
    11: "snapdragon", 12: "colt's foot", 13: "king protea", 14: "spear thistle",
    15: "yellow iris", 16: "globe-flower", 17: "purple coneflower",
    18: "peruvian lily", 19: "balloon flower", 20: "giant white arum lily",
    21: "fire lily", 22: "pincushion flower", 23: "fritillary",
    24: "red ginger", 25: "grape hyacinth", 26: "corn poppy",
    27: "prince of wales feathers", 28: "stemless gentian", 29: "artichoke",
    30: "sweet william", 31: "carnation", 32: "garden phlox",
    33: "love in the mist", 34: "mexican aster", 35: "alpine sea holly",
    36: "ruby-lipped cattleya", 37: "cape flower", 38: "great masterwort",
    39: "siam tulip", 40: "lenten rose", 41: "barbeton daisy", 42: "daffodil",
    43: "sword lily", 44: "poinsettia", 45: "bolero deep blue",
    46: "wallflower", 47: "marigold", 48: "buttercup", 49: "oxeye daisy",
    50: "common dandelion", 51: "petunia", 52: "wild pansy", 53: "primula",
    54: "sunflower", 55: "pelargonium", 56: "bishop of llandaff", 57: "gaura",
    58: "geranium", 59: "orange dahlia", 60: "pink-yellow dahlia",
    61: "cautleya spicata", 62: "japanese anemone", 63: "black-eyed susan",
    64: "silverbush", 65: "californian poppy", 66: "osteospermum",
    67: "spring crocus", 68: "bearded iris", 69: "windflower",
    70: "tree poppy", 71: "gazania", 72: "azalea", 73: "water lily",
    74: "rose", 75: "thorn apple", 76: "morning glory", 77: "passion flower",
    78: "lotus", 79: "toad lily", 80: "anthurium", 81: "frangipani",
    82: "clematis", 83: "hibiscus", 84: "columbine", 85: "desert-rose",
    86: "tree mallow", 87: "magnolia", 88: "cyclamen", 89: "watercress",
    90: "canna lily", 91: "hippeastrum", 92: "bee balm", 93: "ball moss",
    94: "foxglove", 95: "bougainvillea", 96: "camellia", 97: "mallow",
    98: "mexican petunia", 99: "bromelia", 100: "blanket flower",
    101: "trumpet creeper", 102: "blackberry lily",
}


class _SplitRecordsModule(DataModule):
    """Shared setup: subclasses provide _load_records() ->
    (train, val, test, class_names) lists of (path, class_id, image_id)."""

    def setup(self):
        train, val, test, class_names = self._load_records()
        self.class_names = class_names
        train = self._apply_subset(self._apply_few_shot(train))
        self.train_dataset = ImageRecordDataset(
            train, self.train_transform, self.text_prompt, class_names)
        self.val_dataset = ImageRecordDataset(
            val, self.test_transform, self.text_prompt, class_names)
        self.test_dataset = ImageRecordDataset(
            test, self.test_transform, self.text_prompt, class_names)

    def _load_records(self):
        raise NotImplementedError


class Food101DataModule(_SplitRecordsModule):
    DATASET_SUBDIR = "food101"

    def _load_records(self):
        root = self.data_dir / "food-101"
        with open(root / "meta" / "train.json") as f:
            train_meta = json.load(f)
        with open(root / "meta" / "test.json") as f:
            test_meta = json.load(f)
        classes = sorted(train_meta.keys())
        cls_to_id = {c: i for i, c in enumerate(classes)}

        def to_records(meta):
            recs = []
            for cls, stems in meta.items():  # torchvision iterates dict order
                for stem in stems:
                    recs.append((root / "images" / f"{stem}.jpg", cls_to_id[cls], len(recs)))
            return recs

        all_train = to_records(train_meta)
        train, val = train_test_split(all_train, test_size=0.2, random_state=0)
        return train, val, to_records(test_meta), classes


class DTDDataModule(_SplitRecordsModule):
    DATASET_SUBDIR = "dtd"

    def _load_records(self, partition: int = 1):
        root = self.data_dir / "dtd"
        labels_dir = root / "labels"
        images_dir = root / "images"

        def read_split(name):
            with open(labels_dir / f"{name}{partition}.txt") as f:
                return [line.strip() for line in f if line.strip()]

        splits = {s: read_split(s) for s in ("train", "val", "test")}
        classes = sorted({line.split("/")[0] for lines in splits.values() for line in lines})
        cls_to_id = {c: i for i, c in enumerate(classes)}

        def to_records(lines):
            return [(images_dir / line, cls_to_id[line.split("/")[0]], i)
                    for i, line in enumerate(lines)]

        return (to_records(splits["train"]), to_records(splits["val"]),
                to_records(splits["test"]), classes)


class Flowers102DataModule(_SplitRecordsModule):
    DATASET_SUBDIR = "flowers102"

    def _load_records(self):
        from scipy.io import loadmat

        root = self.data_dir / "flowers-102"
        set_ids = loadmat(root / "setid.mat", squeeze_me=True)
        labels = loadmat(root / "imagelabels.mat", squeeze_me=True)["labels"]
        classes = [FLOWERS102_ID_TO_NAME[i] for i in range(1, 103)]

        def to_records(ids):
            return [(root / "jpg" / f"image_{int(i):05d}.jpg", int(labels[int(i) - 1]) - 1, n)
                    for n, i in enumerate(ids)]

        return (to_records(set_ids["trnid"]), to_records(set_ids["valid"]),
                to_records(set_ids["tstid"]), classes)


class StanfordCarsDataModule(_SplitRecordsModule):
    DATASET_SUBDIR = ""  # reference quirk (ref:stanfordcars.py:65)

    def _load_records(self):
        from scipy.io import loadmat

        root = self.data_dir / "stanford_cars"
        devkit = root / "devkit"
        meta = loadmat(devkit / "cars_meta.mat", squeeze_me=True)
        classes = [str(c) for c in meta["class_names"]]

        def to_records(annos_file, image_dir):
            annos = loadmat(annos_file, squeeze_me=True)["annotations"]
            return [(root / image_dir / str(a["fname"]), int(a["class"]) - 1, n)
                    for n, a in enumerate(annos)]

        train = to_records(devkit / "cars_train_annos.mat", "cars_train")
        test = to_records(root / "cars_test_annos_withlabels.mat", "cars_test")
        # the reference uses the train split for val as well
        # (ref:stanfordcars.py:95-122)
        return train, list(train), test, classes
