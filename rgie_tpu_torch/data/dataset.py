"""The captions-feed, COCO-captions and image-directory datasets and host-side
image preprocessing, the rank's view of a dataset and the training-time
augmentations: the port's own copy of ``rgie_tpu/data/dataset.py``, on the
pure-PIL path (numpy out, no framework).

Reference: ``src/datasets/Dataloader.py`` (captions.json map of
{12-digit-id: caption} + images dir) and ``CocoCaptions.py`` (the COCO
annotation format, captions grouped per image and joined with '/').
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def load_image_rgb(path: str) -> np.ndarray:
    """Decode to HWC float32 in [0, 1], forcing RGB (the reference converts
    non-RGB modes, adapter.py:25-27)."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


class CaptionFeedDataset:
    """{root}/annotations/captions.json = {"<id>": caption}; images at
    {root}/images/<12-digit-id>.jpg (Dataloader.py:7-42)."""

    def __init__(self, root: str):
        self.root = Path(root)
        with open(self.root / "annotations" / "captions.json") as f:
            self.captions: Dict[str, str] = json.load(f)
        self.image_dir = self.root / "images"
        self.ids: List[str] = sorted(self.captions.keys())

    def __len__(self) -> int:
        return len(self.ids)

    def image_path(self, image_id: str) -> str:
        name = f"{int(image_id):012d}.jpg"
        return str(self.image_dir / name)

    def __getitem__(self, ix: int) -> Tuple[np.ndarray, Tuple[str, str, str]]:
        image_id = self.ids[ix]
        path = self.image_path(image_id)
        image = load_image_rgb(path)
        name = os.path.basename(path)
        return image, (name, path, self.captions[image_id])


class CocoCaptionsDataset:
    """Real COCO captions_{split}2017.json; multiple captions per image are
    joined with '/' (CocoCaptions.py:16-51)."""

    def __init__(self, root: str, split: str = "val"):
        self.root = Path(root)
        ann = self.root / "annotations" / f"captions_{split}2017.json"
        with open(ann) as f:
            data = json.load(f)
        self.image_dir = self.root / f"{split}2017"
        by_image: Dict[int, List[str]] = {}
        for a in data["annotations"]:
            by_image.setdefault(a["image_id"], []).append(a["caption"])
        files = {img["id"]: img["file_name"] for img in data["images"]}
        self.items: List[Tuple[str, str]] = [
            (files[i], "/".join(caps)) for i, caps in sorted(by_image.items())
            if i in files
        ]

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, ix: int) -> Tuple[np.ndarray, Tuple[str, str, str]]:
        name, caption = self.items[ix]
        path = str(self.image_dir / name)
        return load_image_rgb(path), (name, path, caption)


class ImageDirectoryDataset:
    """Flat directory of images, no captions (referenced by the reference's
    run_img_trans.py:67 for NAPS-style media folders)."""

    EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def __init__(self, root: str):
        self.root = Path(root)
        self.files = sorted(p for p in self.root.iterdir()
                            if p.suffix.lower() in self.EXTENSIONS)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, ix: int) -> Tuple[np.ndarray, Tuple[str, str, str]]:
        path = str(self.files[ix])
        return load_image_rgb(path), (os.path.basename(path), path, "")


class ShardedView:
    """Rank-interleaved view of a dataset for multi-process runs: process p of
    n sees items p, p+n, p+2n, ...

    Every process reports the SAME length (ceil(N / n)), so ranks that step
    in lockstep (midu training's gradient all-reduce) run the same number of
    batches. Trailing ranks whose shard is one item short clamp to the last
    dataset item; ``local_count`` counts a rank's own items without that
    clamp, for the edit CLIs, which need no lockstep and write each output
    once."""

    def __init__(self, dataset, process_index: int, process_count: int):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} out of range "
                             f"for process_count {process_count}")
        self.dataset = dataset
        self.offset = process_index
        self.stride = process_count

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.stride)

    def __getitem__(self, ix: int):
        if ix >= len(self):
            raise IndexError(ix)
        return self.dataset[min(self.offset + ix * self.stride, len(self.dataset) - 1)]

    def local_count(self, limit: Optional[int] = None) -> int:
        """This rank's own items among the dataset's first ``limit`` (all
        without a limit): its leading ``local_count`` items, no clamp."""
        n = len(self.dataset) if limit is None else min(limit, len(self.dataset))
        return len(range(self.offset, n, self.stride))


def first_caption(joined: str) -> str:
    """The adapter uses the first of the '/'-joined captions (adapt_images.py:72)."""
    return joined.split("/")[0]


def preprocess_image(image: np.ndarray, input_size: int, crop_size: int,
                     normalize: bool = False) -> np.ndarray:
    """Host-side torchvision-equivalent Resize(shorter)+CenterCrop+(Normalize)
    producing (1, crop, crop, 3). Matches the entry points' data_transforms
    (optimize_image_param.py:70-75, optimize_image_imaginaire.py:62-67)."""
    from PIL import Image

    h, w = image.shape[:2]
    if h <= w:
        nh, nw = input_size, max(1, round(w * input_size / h))
    else:
        nh, nw = max(1, round(h * input_size / w)), input_size
    pil = Image.fromarray((image * 255).astype(np.uint8))
    pil = pil.resize((nw, nh), Image.BILINEAR)
    arr = np.asarray(pil, dtype=np.float32) / 255.0
    top = (nh - crop_size) // 2
    left = (nw - crop_size) // 2
    arr = arr[top:top + crop_size, left:left + crop_size]
    if normalize:
        arr = (arr - 0.5) / 0.5
    return arr[None]


def iterate_batches(dataset, batch_size: int, input_size: int, crop_size: int,
                    normalize: bool = False, limit: Optional[int] = None
                    ) -> Iterator[Tuple[np.ndarray, List[Tuple[str, str, str]]]]:
    """Batched host iterator (the reference caps runs at 500 images,
    optimize_image.py:25-26: pass limit=500 for parity)."""
    n = len(dataset) if limit is None else min(limit, len(dataset))
    batch_imgs, batch_meta = [], []
    for i in range(n):
        img, meta = dataset[i]
        batch_imgs.append(preprocess_image(img, input_size, crop_size, normalize)[0])
        batch_meta.append(meta)
        if len(batch_imgs) == batch_size:
            yield np.stack(batch_imgs), batch_meta
            batch_imgs, batch_meta = [], []
    if batch_imgs:
        yield np.stack(batch_imgs), batch_meta


def augment_image(image: np.ndarray, rng: np.random.Generator,
                  resize_hw: Optional[Tuple[int, int]] = None,
                  random_crop_hw: Optional[Tuple[int, int]] = None,
                  horizontal_flip: bool = False) -> np.ndarray:
    """Training-time augmentations matching the reference's pipelines: the
    imaginaire Augmentor's resize/random-crop/hflip subset
    (external/imaginaire/utils/data.py:28-437; imagenet2imagenet.yaml:109-115)
    and torchvision's RandomCrop/RandomHorizontalFlip
    (EmotionPredictionModel.get_emo_pred_random_transform:120-133)."""
    from PIL import Image

    if resize_hw is not None:
        pil = Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8))
        pil = pil.resize((resize_hw[1], resize_hw[0]), Image.BILINEAR)
        image = np.asarray(pil, dtype=np.float32) / 255.0
    if random_crop_hw is not None:
        ch, cw = random_crop_hw
        h, w = image.shape[:2]
        top = int(rng.integers(0, max(1, h - ch + 1)))
        left = int(rng.integers(0, max(1, w - cw + 1)))
        image = image[top:top + ch, left:left + cw]
    if horizontal_flip and rng.random() < 0.5:
        image = image[:, ::-1]
    return np.ascontiguousarray(image)
