"""Dataset class-name tables (reference mmdet/core/evaluation/class_names.py):
the port's copy of `mrcnn3d/eval/class_names.py`.

Public dataset label lists used by the VOC-style mAP summary table and
the legacy 2-D tools.  `get_classes` resolves a dataset alias to its
class-name list.
"""
from __future__ import annotations


def voc_classes():
    return [
        "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
        "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
        "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
    ]


def coco_classes():
    return [
        "person", "bicycle", "car", "motorcycle", "airplane", "bus",
        "train", "truck", "boat", "traffic_light", "fire_hydrant",
        "stop_sign", "parking_meter", "bench", "bird", "cat", "dog",
        "horse", "sheep", "cow", "elephant", "bear", "zebra", "giraffe",
        "backpack", "umbrella", "handbag", "tie", "suitcase", "frisbee",
        "skis", "snowboard", "sports_ball", "kite", "baseball_bat",
        "baseball_glove", "skateboard", "surfboard", "tennis_racket",
        "bottle", "wine_glass", "cup", "fork", "knife", "spoon", "bowl",
        "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
        "hot_dog", "pizza", "donut", "cake", "chair", "couch",
        "potted_plant", "bed", "dining_table", "toilet", "tv", "laptop",
        "mouse", "remote", "keyboard", "cell_phone", "microwave", "oven",
        "toaster", "sink", "refrigerator", "book", "clock", "vase",
        "scissors", "teddy_bear", "hair_drier", "toothbrush",
    ]


def imagenet_vid_classes():
    return [
        "airplane", "antelope", "bear", "bicycle", "bird", "bus", "car",
        "cattle", "dog", "domestic_cat", "elephant", "fox", "giant_panda",
        "hamster", "horse", "lion", "lizard", "monkey", "motorcycle",
        "rabbit", "red_panda", "sheep", "snake", "squirrel", "tiger",
        "train", "turtle", "watercraft", "whale", "zebra",
    ]


def microbleed_classes():
    """The 3-D CMB task is single-foreground-class (SURVEY.md section 2.5)."""
    return ["microbleed"]


# alias group -> its table (the JAX package looks up f"{name}_classes",
# which misses imagenet_vid_classes for "vid")
_CLASSES = {"voc": voc_classes, "coco": coco_classes,
            "vid": imagenet_vid_classes, "microbleed": microbleed_classes}

dataset_aliases = {
    "voc": ["voc", "pascal_voc", "voc07", "voc12"],
    "coco": ["coco", "mscoco", "ms_coco"],
    "vid": ["vid", "imagenet_vid", "ilsvrc_vid"],
    "microbleed": ["microbleed", "cmb", "coco3d"],
}


def get_classes(dataset):
    """Resolve a dataset alias to its class-name list."""
    if isinstance(dataset, (list, tuple)):
        return list(dataset)
    if isinstance(dataset, str):
        for name, aliases in dataset_aliases.items():
            if dataset in aliases:
                return _CLASSES[name]()
    raise ValueError(f"unknown dataset {dataset!r}")
