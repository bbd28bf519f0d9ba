"""Built-in dataset metadata, the port of the JAX package's
`data/builtin_meta.py` (reference `datasets/builtin_meta.py`): the 80 COCO
thing classes in contiguous order and the zero-shot COCO caption
(`config/configs/common/data/coco_detr.py:13-21`). VOC's classes live in
`data/incremental_voc.py`; LVIS's names come from its json.
"""

COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

assert len(COCO_CLASSES) == 80


def coco_caption() -> str:
    """The zero-shot COCO caption: the classes joined by "." with a final "."."""
    return ".".join(COCO_CLASSES) + "."
