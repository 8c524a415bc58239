"""One-command mAP parity gate (port of the root ``tools/run_gate.py``):
checkpoint -> streaming eval -> Prophesee COCO -> delta vs the paper
table.

The gate is <= 0.2 mAP against the released upstream checkpoints
(rvt-{t,s,b}.ckpt x {gen1, gen4}, upstream README.md:73-108, evaluated by
upstream validation.py:28-90):

    python -m rvt_tpu_torch.tools.run_gate --ckpt rvt-t.ckpt \
        --data /data/gen1 --dataset gen1 --size tiny [--split test]

Prints one JSON object: all six COCO stats, the paper mAP for that
(dataset, size), the delta, and pass/fail against the 0.2 budget. The
real gate waits for the preprocessed Gen1 / 1 Mpx datasets and the
released checkpoints, which the repository does not hold
(docs/GATE.md); until then it runs on synthetic recordings and on
synthetic checkpoints in the upstream layout.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# Paper table (arXiv:2212.05598). Keys: (dataset, size) -> test mAP.
PAPER_MAP = {
    ("gen1", "base"): 47.2,
    ("gen1", "small"): 46.5,
    ("gen1", "tiny"): 44.1,
    ("gen4", "base"): 47.4,
    ("gen4", "small"): 44.1,
    ("gen4", "tiny"): 41.5,
}

GATE_BUDGET = 0.2  # max |delta| vs the reference checkpoint's mAP

# Published md5 prefixes of the released checkpoints (upstream
# README.md:73-108, the gen1 and "1mpx" tables: 6 hex digits each).
CKPT_MD5 = {
    ("gen1", "base"): "839317",
    ("gen1", "small"): "840f2b",
    ("gen1", "tiny"): "a770b9",
    ("gen4", "base"): "72923a",
    ("gen4", "small"): "a94207",
    ("gen4", "tiny"): "5a3c78",
}


def verify_ckpt_md5(ckpt: Path, dataset: str, size: str) -> str | None:
    """Refuse a corrupted/mismatched download before spending an eval run.

    Returns the computed md5 hex digest, or None when not applicable
    (a checkpoint directory, or no published digest for this combo).
    Raises SystemExit with a clear message on mismatch."""
    import hashlib

    expected = CKPT_MD5.get((dataset, size))
    if expected is None or not Path(ckpt).is_file():
        return None
    h = hashlib.md5()
    with open(ckpt, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    digest = h.hexdigest()
    if not digest.startswith(expected):
        raise SystemExit(
            f"checkpoint md5 mismatch for {ckpt} ({dataset}/{size}): "
            f"got {digest}, expected prefix {expected} "
            f"(reference README.md:73-108). The download is corrupted or "
            f"the wrong file — re-download it, or pass --skip_md5 if this "
            f"is intentionally a different checkpoint.")
    return digest


def run_gate(ckpt: Path, data_dir: Path, dataset: str, size: str,
             split: str = "test", batch_size: int = 8,
             expected_map: float | None = None,
             preset_kwargs: dict | None = None,
             serve_fused: bool = False,
             skip_md5: bool = False, device="cuda") -> dict:
    """Load + evaluate one checkpoint on ``device``; returns the gate
    record.

    preset_kwargs: config overrides (resolution_hw, sequence_length, ...)
    for synthetic fixture datasets; production runs pass none.
    serve_fused: evaluate on the bf16 serving kernels (quantifies their
    mAP delta vs the f32 default)."""
    import torch

    from rvt_tpu_torch.cli.train import build_streams
    from rvt_tpu_torch.cli.validate import load_model, serve_fused_config
    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.data.streaming import EvalStreamScheduler
    from rvt_tpu_torch.training.evaluator_loop import run_streaming_eval

    md5 = None
    if not skip_md5:
        # config overrides do not change the checkpoint file, so the
        # corruption guard applies regardless of preset_kwargs
        md5 = verify_ckpt_md5(ckpt, dataset, size)

    cfg = preset(dataset, size, **(preset_kwargs or {}))
    if serve_fused:
        cfg = serve_fused_config(cfg)
    model = load_model(ckpt, cfg, device)

    streams = build_streams(data_dir, split, cfg)
    sched = EvalStreamScheduler(streams, batch_size)
    metrics = run_streaming_eval(model, cfg, iter(sched), batch_size,
                                 device=device)

    record = {
        "dataset": dataset,
        "size": size,
        "split": split,
        "serve_fused": serve_fused,
        "checkpoint": str(ckpt),
        "num_recordings": len(streams),
        "device": torch.device(device).type,
        **({"ckpt_md5": md5} if md5 else {}),
        **{k: float(v) for k, v in metrics.items()},
    }
    paper = PAPER_MAP.get((dataset, size))
    if paper is not None:
        record["paper_map"] = paper
        record["delta_vs_paper"] = round(100.0 * record["AP"] - paper, 3)
    if expected_map is not None:
        delta = abs(100.0 * record["AP"] - expected_map)
        record["expected_map"] = expected_map
        record["delta_vs_expected"] = round(delta, 3)
        record["gate_pass"] = bool(delta <= GATE_BUDGET)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", type=Path, required=True,
                    help="upstream .ckpt / .pt (or a Trainer checkpoint "
                         "directory) to gate")
    ap.add_argument("--data", type=Path, required=True,
                    help="preprocessed dataset root (<split>/<recording>/...)")
    ap.add_argument("--dataset", choices=["gen1", "gen4"], required=True)
    ap.add_argument("--size", choices=["tiny", "small", "base"],
                    default=None, help="inferred from ckpt name if omitted")
    ap.add_argument("--split", default="test", choices=["val", "test"])
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--expected_map", type=float, default=None,
                    help="reference-checkpoint mAP to gate against "
                         "(<=0.2 delta); defaults to the paper value")
    ap.add_argument("--serve_fused", action="store_true",
                    help="evaluate on the bf16 serving kernels")
    ap.add_argument("--skip_md5", action="store_true",
                    help="skip checkpoint md5 verification (e.g. for "
                         "self-trained checkpoints)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    size = args.size
    if size is None:
        stem = args.ckpt.stem.lower()
        size = {"t": "tiny", "s": "small", "b": "base"}.get(
            stem.rsplit("-", 1)[-1][:1])
        assert size, f"cannot infer size from {args.ckpt}; pass --size"

    expected = args.expected_map
    if expected is None:
        expected = PAPER_MAP.get((args.dataset, size))
    record = run_gate(args.ckpt, args.data, args.dataset, size,
                      split=args.split, batch_size=args.batch_size,
                      expected_map=expected, serve_fused=args.serve_fused,
                      skip_md5=args.skip_md5, device=args.device)
    print(json.dumps(record, indent=2))
    if record.get("gate_pass") is False:
        sys.exit(1)


if __name__ == "__main__":
    main()
