"""Image directory walking (port of ``dsgan_tpu/data/image_folder.py``,
reference DSGAN/data/image_folder.py).

``make_dataset`` walks the directory in sorted order and splits the list
in half: the first half is domain A (TIR), the second domain B (RGB)
(reference image_folder.py:24-34). The shipped KAIST/IRVI recipes rely on
this pairing rule, so it is kept as it is.
"""

import os

IMG_EXTENSIONS = [
    ".jpg", ".JPG", ".jpeg", ".JPEG",
    ".png", ".PNG", ".ppm", ".PPM", ".bmp", ".BMP",
]


def is_image_file(filename):
    return any(filename.endswith(ext) for ext in IMG_EXTENSIONS)


def make_dataset(dir):
    """Sorted walk, then half-split -> (A_paths, B_paths)."""
    if not os.path.isdir(dir):
        raise FileNotFoundError(f"{dir} is not a valid directory")
    images = []
    for root, _, fnames in sorted(os.walk(dir)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    ix = len(images) // 2
    return images[:ix], images[ix:]


def list_images(dir):
    """Flat sorted list of all images under ``dir`` (no split)."""
    a, b = make_dataset(dir)
    return a + b
