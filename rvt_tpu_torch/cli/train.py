"""Training CLI helpers (port of ``rvt_tpu/cli/train.py``).

Only ``build_streams`` is ported so far: the validation CLI and the gate
read recordings through it. The training entry point (``main``: the
train samplers and the augmentor on the port's Trainer) is not ported
yet (ROADMAP).
"""
from __future__ import annotations

from pathlib import Path


def build_streams(data_dir: Path, split: str, cfg, train: bool):
    """One ``StreamView`` per recording under ``<data_dir>/<split>`` (for
    training, the label-dense sub-streams of each)."""
    from rvt_tpu_torch.data.sequence import Recording, StreamView

    split_dir = Path(data_dir) / split
    assert split_dir.is_dir(), split_dir
    streams = []
    for rec_dir in sorted(p for p in split_dir.iterdir() if p.is_dir()):
        rec = Recording(rec_dir, cfg.dataset.ev_repr_name,
                        original_hw=cfg.dataset.resolution_hw,
                        downsample_by_factor_2=cfg.dataset.downsample_by_factor_2,
                        max_labels_per_frame=cfg.dataset.max_labels_per_frame)
        if train:
            streams.extend(StreamView.with_guaranteed_labels(
                rec, cfg.dataset.sequence_length))
        else:
            streams.append(StreamView(rec, cfg.dataset.sequence_length))
    return streams
