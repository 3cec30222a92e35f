"""FID / KID between two image folders (port of ``dsgan_tpu/fid.py``).

    python -m dsgan_tpu_torch.fid --dir_a results/exp/test_all_20/images \
        --dir_b /data/testB --inception_weights inception.npz

The JAX CLI's flags and its one JSON line (``fid``, ``n_a``, ``n_b``,
``kid``, ``kid_std``). ``--inception_weights`` is a torchvision (or
pytorch-fid) Inception3 ``state_dict`` saved as an npz, or ``random``
(pipeline tests only). Images go to the extractor at their own size and
are resized to 299 on the device as the JAX package resizes them
(``models/inception.py::prepare_images``); a folder of mixed sizes is
brought to its first image's size on the host. Runs on the CUDA card;
``--platform cpu`` runs on the CPU.
"""

import argparse
import json
import sys

import numpy as np

from dsgan_tpu_torch.device import platform_device


def _load_folder(path, suffix, limit):
    from PIL import Image

    from dsgan_tpu_torch.data.image_folder import list_images

    files = list_images(path)
    if suffix:
        files = [f for f in files if suffix in f.rsplit("/", 1)[-1]]
    files = files[:limit]
    if not files:
        raise SystemExit(f"no images found under {path!r} (suffix={suffix!r})")
    for f in files:
        yield np.asarray(Image.open(f).convert("RGB"), np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir_a", required=True, help="first image folder (e.g. generated)")
    ap.add_argument("--dir_b", required=True, help="second image folder (e.g. real)")
    ap.add_argument("--suffix_a", default="", help="keep only filenames containing this "
                    "(e.g. fake_B to pick generated images out of a results gallery)")
    ap.add_argument("--suffix_b", default="")
    ap.add_argument("--inception_weights", default="random",
                    help="torchvision Inception3 state_dict as an .npz; 'random' = pipeline "
                         "test only")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--how_many", type=int, default=50000)
    ap.add_argument("--no_kid", action="store_true")
    ap.add_argument("--torchvision_graph", action="store_true",
                    help="use the literal torchvision graph instead of the FID variant")
    ap.add_argument("--platform", default="",
                    help="device: empty, gpu or cuda = the CUDA card (raises without one); "
                         "cpu = the CPU")
    args = ap.parse_args(argv)

    from dsgan_tpu_torch.models.inception import make_feature_fn
    from dsgan_tpu_torch.ops import fid as fid_ops

    extract = make_feature_fn(args.inception_weights, fid_variant=not args.torchvision_graph,
                              batch=args.batch, device=platform_device(args.platform))
    fa = extract(_load_folder(args.dir_a, args.suffix_a, args.how_many))
    fb = extract(_load_folder(args.dir_b, args.suffix_b, args.how_many))
    if min(len(fa), len(fb)) < 2:
        raise SystemExit("FID needs >= 2 images per folder (covariance is undefined below "
                         f"that): got {len(fa)} / {len(fb)}")
    out = {"fid": fid_ops.fid_from_features(fa, fb), "n_a": int(len(fa)), "n_b": int(len(fb))}
    if not args.no_kid:
        kid_mean, kid_std = fid_ops.kid_from_features(fa, fb,
                                                      subset_size=min(len(fa), len(fb), 100))
        out["kid"] = kid_mean
        out["kid_std"] = kid_std
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
