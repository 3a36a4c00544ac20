"""Dataset / model / training analysis CLI.

Counterpart of the JAX package's ``analyze.py`` (:1-474), itself the
equivalent of the reference's analysis tooling (the ~20 top-level
`analyze_*.py` one-off scripts plus `print_coco_640x480_images.py`),
consolidated into subcommands:

  stats        data_analyze_*.json producer (analyze_data_full.py /
               analyze_pixel_ratio.py) — image/instance counts, per-class
               pixel ratios the training loop consumes, instance histogram.
               Schema matches the reference's data_analyze_full.json
               (pixel ratios .4865/.3660/.1476 on full COCO-person).
  bboxes       bbox distribution + quality issues (analyze_dataset_bboxes.py;
               thresholds from filtered_dataset.py:11-135 — min side 30px,
               aspect in [0.2, 5.0]).
  roi-sizes    ROI sizes after resize to the training resolution with
               percentiles and a suggested roi_size (analyze_roi_sizes.py).
  complexity   parameter counts / FLOPs / optional timed forward for named
               registry configs (analyze_model_complexity.py).
  training     summarize a TrainLogger JSONL run: per-epoch loss/mIoU, best
               epoch (analyze_training.py — reads our JSONL instead of
               TensorBoard event files).
  temperature  KL-magnitude-vs-temperature sweep using the binary-KD math
               (analyze_temperature_kl_effect.py over
               unet_decoder_distillation.py:510-663 semantics).
  images       print file_names whose size matches WxH, optionally resizing
               them to disk (print_coco_640x480_images.py).

Legacy invocation (`analyze --annotations ...` with no subcommand) keeps the
round-1 behavior and runs `stats`.

Everything but ``complexity`` and ``temperature`` is the JAX module's numpy
code. ``complexity`` builds the port's models on the card (``--device cpu``
for the host) and counts their parameters exactly as JAX counts them
(every parameter and running statistic of the model, JAX's ``params`` and
``batch_stats`` leaves); its
FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, which counts
the convolutions and matrix products only (two a multiply-add), where
XLA's ``cost_analysis`` counts the compiled program's operations,
elementwise work included, after XLA's own rewrites. The two figures are
not the same measure; ``tests/test_torch_analyze_experiments.py`` records
their ratio on a tiny config.
``temperature`` computes the same clamped sigmoid-KL in torch (float32).

    python -m human_instance_segmentation_tpu_torch.analyze <subcommand> ...
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter, defaultdict
from typing import Dict, List, Optional

import numpy as np


def analyze_dataset(
    annotations: str,
    image_dir: str = "",
    mask_size=(56, 56),
    rois_per_image: int = 10,
    max_images: Optional[int] = None,
) -> Dict:
    from .data import COCOIndex
    from .data.coco import ann_to_mask

    coco = annotations if isinstance(annotations, COCOIndex) else COCOIndex(annotations)
    img_ids = coco.get_img_ids()
    if max_images:
        img_ids = img_ids[:max_images]

    num_instances = 0
    pixel_counts = np.zeros(3, np.int64)
    inst_hist: Counter = Counter()
    widths, heights, aspects = [], [], []

    for img_id in img_ids:
        info = coco.load_imgs(img_id)[0]
        anns = coco.load_anns(coco.get_ann_ids(img_id, iscrowd=False))
        if not anns:
            continue
        inst_hist[min(len(anns), 20)] += 1
        num_instances += len(anns)
        masks = [ann_to_mask(a, info["height"], info["width"]) for a in anns]
        for ti, ann in enumerate(anns[:rois_per_image]):
            x, y, w, h = [int(round(v)) for v in ann["bbox"]]
            x2, y2 = min(x + max(w, 1), info["width"]), min(y + max(h, 1), info["height"])
            x, y = max(x, 0), max(y, 0)
            if x2 <= x or y2 <= y:
                continue
            roi = np.zeros((y2 - y, x2 - x), np.uint8)
            roi[masks[ti][y:y2, x:x2] > 0] = 1
            for oi, om in enumerate(masks):
                if oi != ti:
                    roi[(om[y:y2, x:x2] > 0) & (roi == 0)] = 2
            counts = np.bincount(roi.reshape(-1), minlength=3)
            pixel_counts += counts[:3]
            widths.append(w)
            heights.append(h)
            aspects.append(w / max(h, 1))

    total = max(int(pixel_counts.sum()), 1)
    return {
        "num_images": len(img_ids),
        "num_instances": num_instances,
        "pixel_ratios": {
            "background": round(float(pixel_counts[0]) / total, 4),
            "target": round(float(pixel_counts[1]) / total, 4),
            "non_target": round(float(pixel_counts[2]) / total, 4),
        },
        "instance_count_histogram": dict(sorted(inst_hist.items())),
        "bbox_stats": {
            "width_mean": float(np.mean(widths)) if widths else 0.0,
            "height_mean": float(np.mean(heights)) if heights else 0.0,
            "aspect_mean": float(np.mean(aspects)) if aspects else 0.0,
            "aspect_p05": float(np.percentile(aspects, 5)) if aspects else 0.0,
            "aspect_p95": float(np.percentile(aspects, 95)) if aspects else 0.0,
        },
    }


def analyze_bboxes(
    annotations: str,
    min_size: float = 30.0,
    aspect_range=(0.2, 5.0),
    max_images: Optional[int] = None,
) -> Dict:
    """Bbox size/aspect distribution + quality flags.

    Mirrors the reference's analyze_dataset_bboxes.py (distribution, tiny
    boxes, degenerate boxes) with the acceptance thresholds the reference's
    FilteredCOCODataset applies (filtered_dataset.py:11-135).
    """
    from .data import COCOIndex

    coco = annotations if isinstance(annotations, COCOIndex) else COCOIndex(annotations)
    img_ids = coco.get_img_ids()
    if max_images:
        img_ids = img_ids[:max_images]

    widths, heights, areas, aspects = [], [], [], []
    n_tiny = n_extreme_aspect = n_degenerate = n_total = 0
    for img_id in img_ids:
        for ann in coco.load_anns(coco.get_ann_ids(img_id, iscrowd=False)):
            x, y, w, h = ann["bbox"]
            n_total += 1
            if w <= 0 or h <= 0:
                n_degenerate += 1
                continue
            widths.append(w)
            heights.append(h)
            areas.append(w * h)
            a = w / h
            aspects.append(a)
            if min(w, h) < min_size:
                n_tiny += 1
            if not (aspect_range[0] <= a <= aspect_range[1]):
                n_extreme_aspect += 1

    def pct(v, q):
        return float(np.percentile(v, q)) if v else 0.0

    return {
        "num_boxes": n_total,
        "width": {q: pct(widths, q) for q in (5, 25, 50, 75, 95)},
        "height": {q: pct(heights, q) for q in (5, 25, 50, 75, 95)},
        "area": {q: pct(areas, q) for q in (5, 25, 50, 75, 95)},
        "aspect": {q: pct(aspects, q) for q in (5, 25, 50, 75, 95)},
        "issues": {
            "degenerate": n_degenerate,
            f"tiny_lt_{int(min_size)}px": n_tiny,
            "extreme_aspect": n_extreme_aspect,
            "kept_fraction": round(
                (n_total - n_degenerate - n_tiny - n_extreme_aspect) / max(n_total, 1), 4),
        },
    }


def analyze_roi_sizes(
    annotations: str,
    image_size=(640, 640),
    max_images: Optional[int] = None,
) -> Dict:
    """ROI pixel sizes after the dataset resize, with a suggested roi_size.

    Mirrors the reference's analyze_roi_sizes.py: boxes are scaled to the
    training resolution (the dataset resizes every image to 640x640,
    dataset.py:15-256), percentiles reported, and a 16-multiple roi_size
    suggestion derived from the median box and mean aspect (the reference
    settles on 64x48-style H>W sizes for people).
    """
    from .data import COCOIndex

    coco = annotations if isinstance(annotations, COCOIndex) else COCOIndex(annotations)
    ih, iw = image_size
    img_ids = coco.get_img_ids()
    if max_images:
        img_ids = img_ids[:max_images]

    ws, hs = [], []
    for img_id in img_ids:
        info = coco.load_imgs(img_id)[0]
        sx, sy = iw / info["width"], ih / info["height"]
        for ann in coco.load_anns(coco.get_ann_ids(img_id, iscrowd=False)):
            x, y, w, h = ann["bbox"]
            if w <= 0 or h <= 0:
                continue
            ws.append(w * sx)
            hs.append(h * sy)

    def pcts(v):
        return {q: float(np.percentile(v, q)) if v else 0.0 for q in (5, 25, 50, 75, 95)}

    med_w = float(np.median(ws)) if ws else 0.0
    med_h = float(np.median(hs)) if hs else 0.0

    def to16(v):
        return max(16, int(round(v / 16)) * 16)

    return {
        "num_boxes": len(ws),
        "image_size": [ih, iw],
        "roi_width_px": pcts(ws),
        "roi_height_px": pcts(hs),
        "median_box": [med_h, med_w],
        "suggested_roi_size": [to16(med_h / 2), to16(med_w / 2)],
    }


def analyze_complexity(
    config_names: List[str],
    tiny: bool = False,
    timed: bool = False,
    device: str = "cuda",
) -> Dict[str, Dict]:
    """Params / FLOPs / (optional) timed forward per registry config.

    Mirrors the reference's analyze_model_complexity.py. Parameters are
    counted as the JAX package counts its variables: every parameter and
    running statistic. FLOPs are ``FlopCounterMode``'s count of one eval
    forward of one image and one ROI (convolutions and matrix products
    only; the module docstring says how it differs from XLA's). The models
    are built on ``device``: the card by default, where ``timed`` times the
    forward; ``"cpu"`` asks for the host, and ``"cuda"`` without CUDA raises.
    """
    import time

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .config import ConfigManager, _as_hw, model_from_config

    out: Dict[str, Dict] = {}
    for name in config_names:
        cfg = ConfigManager.get_config(name)
        if tiny:
            cfg.model.image_size = (64, 64)
            cfg.model.roi_size = (16, 12)
            cfg.model.mask_size = (32, 24)
            cfg.model.encoder_name = "tiny"
            cfg.model.hierarchical_base_channels = 16
            cfg.model.hierarchical_depth = 2
        model = model_from_config(cfg, device=device).eval()
        ih, iw = _as_hw(cfg.model.image_size)
        images = torch.zeros((1, ih, iw, 3), device=device)
        rois = torch.tensor([[0.0, 0.2, 0.2, 0.8, 0.8]], device=device)
        n_params = int(sum(p.numel() for p in model.parameters())
                       + sum(b.numel() for b in model.buffers() if b.is_floating_point()))
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), counter:
            model(images, rois)
        flops = float(counter.get_total_flops())
        rec = {"params": n_params, "params_m": round(n_params / 1e6, 2),
               "gflops_per_image": round(flops / 1e9, 2)}
        if timed:
            with torch.no_grad():
                model(images, rois)
                if images.is_cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    model(images, rois)
                if images.is_cuda:
                    torch.cuda.synchronize()
            rec["ms_per_image"] = round((time.perf_counter() - t0) / 5 * 1e3, 2)
        out[name] = rec
    return out


def analyze_training(log_path: str, prefix: str = "val",
                     key: str = "target_miou") -> Dict:
    """Summarize a TrainLogger JSONL run (analyze_training.py, sans TB).

    Groups metric lines by prefix, reports first/last/best of the selection
    key and the loss trajectory.
    """
    from pathlib import Path

    p = Path(log_path)
    if p.is_dir():
        cands = sorted(p.glob("*.jsonl"))
        if not cands:
            raise FileNotFoundError(f"no .jsonl under {log_path}")
        p = cands[-1]

    rows: Dict[str, List[Dict]] = defaultdict(list)
    with open(p) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            rows[rec.get("prefix", "train")].append(rec)

    summary: Dict = {"file": str(p), "prefixes": {}}
    for pr, rs in rows.items():
        losses = [r["total_loss"] for r in rs if "total_loss" in r]
        entry = {"rows": len(rs),
                 "first_step": rs[0].get("step"), "last_step": rs[-1].get("step")}
        if losses:
            entry["loss_first"] = round(losses[0], 4)
            entry["loss_last"] = round(losses[-1], 4)
            entry["loss_min"] = round(min(losses), 4)
        summary["prefixes"][pr] = entry

    sel = [r for r in rows.get(prefix, []) if key in r]
    if sel:
        best = max(sel, key=lambda r: r[key])
        summary["best"] = {"step": best.get("step"), key: round(best[key], 4)}
    return summary


def analyze_temperature(
    t_init: float = 10.0,
    t_final: float = 1.0,
    epochs: int = 30,
    schedule: str = "linear",
) -> Dict:
    """KL magnitude vs temperature (analyze_temperature_kl_effect.py).

    Sweeps the binary-KD temperature schedule and reports the KL and
    gradient-scale (T^2-compensated) magnitudes on representative
    student/teacher logit gaps, using the same clamped sigmoid-KL as
    losses/distillation.py::unet_distillation_loss.
    """
    import torch

    from .losses.distillation import DistillationConfig, scheduled_temperature

    cfg = DistillationConfig(initial_temperature=t_init, final_temperature=t_final,
                             schedule_type=schedule)
    rng = np.random.default_rng(0)
    teacher = torch.as_tensor(rng.normal(0.0, 4.0, (1, 64, 64)).astype(np.float32))
    student = teacher + torch.as_tensor(rng.normal(0.0, 2.0, (1, 64, 64)).astype(np.float32))

    def kl_at(T):
        eps = 1e-5
        s = torch.clamp(torch.sigmoid(torch.clamp(student, -10, 10) / T), eps, 1 - eps)
        t = torch.clamp(torch.sigmoid(torch.clamp(teacher, -10, 10) / T), eps, 1 - eps)
        kl = torch.mean(t * (torch.log(t + eps) - torch.log(s + eps))
                        + (1 - t) * (torch.log(1 - t + eps) - torch.log(1 - s + eps)))
        return float(torch.clamp(kl, 0.0, 5.0))

    rows = []
    for e in range(epochs):
        T = scheduled_temperature(cfg, e, epochs)
        kl = kl_at(T)
        rows.append({"epoch": e, "temperature": round(float(T), 3),
                     "kl": round(kl, 5),
                     "kl_t2_scaled": round(kl * float(T) ** 2, 5)})
    return {"schedule": schedule, "rows": rows}


def list_images_by_size(
    annotations: str,
    size=(640, 480),
    resize: Optional[tuple] = None,
    images_root: str = "",
    out_dir: str = "resized_images",
) -> List[str]:
    """file_names whose (width, height) == size; optional resize-to-disk.

    Mirrors the reference's print_coco_640x480_images.py (annotation-driven
    size filter + optional PIL resize into an output directory).
    """
    from .data import COCOIndex

    coco = annotations if isinstance(annotations, COCOIndex) else COCOIndex(annotations)
    w, h = size
    names = [info["file_name"] for info in coco.load_imgs(coco.get_img_ids())
             if info["width"] == w and info["height"] == h]

    if resize and images_root:
        from pathlib import Path

        from PIL import Image

        Path(out_dir).mkdir(parents=True, exist_ok=True)
        for n in names:
            src = Path(images_root) / n
            if not src.exists():
                continue
            Image.open(src).resize(resize).save(Path(out_dir) / n)
    return names


def main(argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # legacy round-1 CLI: no subcommand, just --annotations [--out --max_images]
    subs = {"stats", "bboxes", "roi-sizes", "complexity", "training",
            "temperature", "images"}
    if argv and argv[0] not in subs:
        argv = ["stats"] + argv

    p = argparse.ArgumentParser(description=__doc__)
    sp = p.add_subparsers(dest="cmd", required=True)

    ps = sp.add_parser("stats")
    ps.add_argument("--annotations", required=True)
    ps.add_argument("--out", default="data_analyze.json")
    ps.add_argument("--max_images", type=int, default=None)

    pb = sp.add_parser("bboxes")
    pb.add_argument("--annotations", required=True)
    pb.add_argument("--min_size", type=float, default=30.0)
    pb.add_argument("--aspect", type=float, nargs=2, default=(0.2, 5.0))
    pb.add_argument("--max_images", type=int, default=None)

    pr = sp.add_parser("roi-sizes")
    pr.add_argument("--annotations", required=True)
    pr.add_argument("--image_size", type=int, nargs=2, default=(640, 640))
    pr.add_argument("--max_images", type=int, default=None)

    pc = sp.add_parser("complexity")
    pc.add_argument("configs", nargs="+")
    pc.add_argument("--tiny", action="store_true")
    pc.add_argument("--timed", action="store_true")
    pc.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    pt = sp.add_parser("training")
    pt.add_argument("--log", required=True, help="JSONL file or TrainLogger dir")
    pt.add_argument("--prefix", default="val")
    pt.add_argument("--key", default="target_miou")

    pk = sp.add_parser("temperature")
    pk.add_argument("--t_init", type=float, default=10.0)
    pk.add_argument("--t_final", type=float, default=1.0)
    pk.add_argument("--epochs", type=int, default=30)
    pk.add_argument("--schedule", default="linear",
                    choices=("linear", "cosine", "exponential"))

    pi = sp.add_parser("images")
    pi.add_argument("--annotations", required=True)
    pi.add_argument("--size", default="640x480", help="WxH")
    pi.add_argument("--resize", default=None, help="W,H")
    pi.add_argument("--images_root", default="")
    pi.add_argument("--out_dir", default="resized_images")

    args = p.parse_args(argv)

    if args.cmd == "stats":
        stats = analyze_dataset(args.annotations, max_images=args.max_images)
        with open(args.out, "w") as f:
            json.dump(stats, f, indent=2)
        print(json.dumps(stats["pixel_ratios"]))
    elif args.cmd == "bboxes":
        print(json.dumps(analyze_bboxes(args.annotations, args.min_size,
                                        tuple(args.aspect), args.max_images),
                         indent=2))
    elif args.cmd == "roi-sizes":
        print(json.dumps(analyze_roi_sizes(args.annotations,
                                           tuple(args.image_size),
                                           args.max_images), indent=2))
    elif args.cmd == "complexity":
        print(json.dumps(analyze_complexity(args.configs, tiny=args.tiny,
                                            timed=args.timed, device=args.device), indent=2))
    elif args.cmd == "training":
        print(json.dumps(analyze_training(args.log, args.prefix, args.key),
                         indent=2))
    elif args.cmd == "temperature":
        print(json.dumps(analyze_temperature(args.t_init, args.t_final,
                                             args.epochs, args.schedule),
                         indent=2))
    elif args.cmd == "images":
        w, h = (int(v) for v in args.size.lower().split("x"))
        resize = tuple(int(v) for v in args.resize.split(",")) if args.resize else None
        for n in list_images_by_size(args.annotations, (w, h), resize,
                                     args.images_root, args.out_dir):
            print(n)


if __name__ == "__main__":
    main()
