"""Qualitative PNGs of the paper's example subjects: the image, the ground
truth and prediction overlays and the inferno uncertainty map, on the
displayed slice, cropped to the image's bounding box
(``bin/save_images.py`` counterpart).

The uncertainty preparation (``eval.analysis.get_uncertainty_preparation``:
the entropy of the probabilities, or the rescaled confidence or sigma) runs
as torch ops on ``--device`` (default cuda); the prepared maps come to the
host once a subject. The slice, the box and the crops are numpy
(:func:`subject_images`); the ``save_*`` functions draw through
matplotlib, imported there alone.

  python -m rcu_tpu_torch.cli.save_images [--ds brats|isic] [--ids ...] \\
      [--device cpu]
"""
import argparse
import os

import numpy as np
import torch

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.analysis import pyplot
from rcu_tpu_torch.eval import analysis, evaldata as evdata

BRATS_SUBJECTS = ["Brats18_TCIA01_390_1", "Brats18_CBICA_AUN_1",
                  "Brats18_CBICA_ASY_1"]
ISIC_SUBJECTS = ["ISIC_0012388", "ISIC_0012654", "ISIC_0012447"]
DEFAULT_IDS = ["baseline", "baseline_mc", "center", "center_mc", "ensemble",
               "auxiliary_feat", "auxiliary_segm", "aleatoric"]


def select_slice(data: dict, dataset: str):
    """The displayed slice: BraTS the slice with the largest ground-truth
    area, ISIC (native 2-D) the whole image."""
    if dataset == "isic":
        return slice(None)
    return int(np.argmax(data["target"].sum(axis=(1, 2))))


def get_bbox(img: np.ndarray, squared: str = "max", dims: int = None):
    """The display box of the non-zero region, ((h0, h1), (w0, w1)):

    - per axis, [first, last] non-zero index, a margin of 10 added on each
      side only where it stays inside the image (the upper bound then
      stays the last index);
    - ``squared='max'`` (BraTS) pads every axis outward to the largest
      extent (floor-split between the sides), ``squared='min'`` (ISIC)
      shrinks every axis inward to the smallest;
    - ``dims=2`` restricts to the leading two axes (ISIC images are
      H x W x 3).

    A box that leaves the image fails an ``AssertionError``, as in the JAX
    tool; an all-zero image fails its index."""
    if dims is None:
        dims = img.ndim
    bounds = []
    for keep in range(dims):
        other = tuple(ax for ax in range(dims) if ax != keep)
        nonzero = np.any(img, axis=other) if img.ndim == dims else \
            np.any(img, axis=other + tuple(range(dims, img.ndim)))
        idx = np.where(nonzero)[0]
        lo, hi = int(idx[0]), int(idx[-1])
        if lo - 10 >= 0:
            lo -= 10
        if hi + 10 <= nonzero.shape[0]:
            hi += 10
        bounds.append((lo, hi))
    if squared == "max":
        target = max(hi - lo for lo, hi in bounds)
        for i, (lo, hi) in enumerate(bounds):
            diff = target - (hi - lo)
            bounds[i] = (lo - diff // 2, hi + (diff - diff // 2))
            if not (bounds[i][0] >= 0 and bounds[i][1] < img.shape[i]):
                raise AssertionError
    elif squared == "min":
        target = min(hi - lo for lo, hi in bounds)
        for i, (lo, hi) in enumerate(bounds):
            diff = (hi - lo) - target
            bounds[i] = (lo + diff // 2, hi - (diff - diff // 2))
            if not (bounds[i][0] >= 0 and bounds[i][1] < img.shape[i]):
                raise AssertionError
    return tuple(bounds)


def apply_bbox(img: np.ndarray, bbox):
    (h0, h1), (w0, w1) = bbox
    return img[h0:h1, w0:w1]


def prepared_subject(prepare, sf, confidence_entry: str, img_key: str,
                     device) -> dict:
    """One subject's image, ground truth, prediction and prepared
    uncertainty map as host arrays: read by ``eval.analysis.Loader``,
    prepared on ``device``, copied back once."""
    sample = analysis.Loader().get_data(sf, confidence_entry,
                                        images=(img_key,))
    sample = prepare({k: torch.from_numpy(v).to(device)
                      for k, v in sample.items()})
    return {k: sample[k].cpu().numpy()
            for k in (img_key, "target", "prediction", "uncertainty")}


def subject_images(d: dict, img_key: str, dataset: str) -> dict:
    """The arrays a subject's PNGs show: the slice (``slice_str`` the file
    names' suffix), the box, and the cropped image, ground truth,
    prediction and uncertainty map."""
    sel = select_slice(d, dataset)
    img = d[img_key][sel]
    bbox = get_bbox(img, squared="max", dims=None) \
        if dataset == "brats" else get_bbox(img, squared="min", dims=2)
    return {"sel": sel, "bbox": bbox,
            "slice_str": "" if isinstance(sel, slice) else f"_sl{sel}",
            "image": apply_bbox(img, bbox),
            "gt": apply_bbox(d["target"][sel], bbox),
            "prediction": apply_bbox(d["prediction"][sel], bbox),
            "uncertainty": apply_bbox(d["uncertainty"][sel], bbox)}


def save_image(arr, path, cmap="gray", norm=None):
    plt = pyplot()
    arr = np.asarray(arr)
    if arr.ndim == 3 and np.issubdtype(arr.dtype, np.floating):
        # float RGB: clipped to [0, 1], as imshow does (imsave raises)
        arr = np.clip(arr, 0.0, 1.0)
    if norm is not None:
        plt.imsave(path, arr, cmap=cmap, vmin=norm.vmin, vmax=norm.vmax)
    else:
        plt.imsave(path, arr, cmap=cmap)


def save_overlay(img, mask, path, color=(1, 0, 0), alpha=0.5):
    plt = pyplot()
    from matplotlib import colors
    fig, ax = plt.subplots()
    ax.imshow(img, cmap="gray")
    cm = colors.LinearSegmentedColormap.from_list("ov", [color, color], N=2)
    ax.imshow(np.ma.masked_where(mask == 0, mask), cmap=cm, alpha=alpha,
              interpolation="none")
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def save_colorbar(path):
    plt = pyplot()
    from matplotlib import colors
    fig, ax = plt.subplots(figsize=(0.4, 4))
    fig.colorbar(plt.cm.ScalarMappable(norm=colors.Normalize(0, 1),
                                       cmap="inferno"), cax=ax)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def write_subject_images(subject_dir: str, id_: str, img_key: str, d: dict,
                         dataset: str):
    """A subject's PNGs under the JAX tool's file names: the slice suffix
    on the image and ground-truth files only; the uncertainty map
    autoscaled."""
    s = subject_images(d, img_key, dataset)
    slice_str = s["slice_str"]
    save_image(s["image"], os.path.join(subject_dir,
                                        f"{img_key}{slice_str}.png"))
    save_overlay(s["image"], s["gt"], os.path.join(
        subject_dir, f"{img_key}_gt_overlay{slice_str}.png"), color=(0, 1, 0))
    save_overlay(s["image"], s["prediction"], os.path.join(
        subject_dir, f"{id_}_{img_key}_pred_overlay.png"), color=(1, 0, 0))
    save_image(s["uncertainty"], os.path.join(subject_dir, f"{id_}_uncert.png"),
               cmap="inferno")


def main(dataset: str, to_plot: list, device=None):
    from rcu_tpu_torch.eval.direct import resolve_device
    if dataset not in ("brats", "isic"):
        raise ValueError(f'Invalid dataset "{dataset}". Chose "brats" or "isic"')
    device = resolve_device(device)

    if dataset == "brats":
        eval_data_list = evdata.get_brats_eval_data(to_plot)
        subjects = BRATS_SUBJECTS
        min_max_dir = os.path.join(dirs.BRATS_EVAL_DIR, dirs.MINMAX_NAME)
        plot_dir = os.path.join(dirs.BRATS_PLOT_DIR, "images")
        img_key = "flair"
    else:
        eval_data_list = evdata.get_isic_eval_data(to_plot)
        subjects = ISIC_SUBJECTS
        min_max_dir = os.path.join(dirs.ISIC_EVAL_DIR, dirs.MINMAX_NAME)
        plot_dir = os.path.join(dirs.ISIC_PLOT_DIR, "images")
        img_key = "image"

    os.makedirs(plot_dir, exist_ok=True)
    save_colorbar(os.path.join(plot_dir, "colorbar.png"))

    for entry in eval_data_list:
        prepare, id_ = analysis.get_uncertainty_preparation(
            entry, rescale_confidence="subject", rescale_sigma="global",
            min_max_dir=min_max_dir)
        print(id_)
        for sf in (s for s in entry.subject_files if s.subject in subjects):
            subject_dir = os.path.join(plot_dir, sf.subject)
            os.makedirs(subject_dir, exist_ok=True)
            d = prepared_subject(prepare, sf, entry.confidence_entry, img_key,
                                 device)
            write_subject_images(subject_dir, entry.id_, img_key, d, dataset)


def cli():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ds", type=str, nargs="?", default="brats")
    parser.add_argument("--ids", type=str, nargs="*", default=DEFAULT_IDS)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the preparation (default cuda)")
    args = parser.parse_args()
    main(args.ds, args.ids, device=args.device)


if __name__ == "__main__":
    cli()
