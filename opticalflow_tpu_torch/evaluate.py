"""Dataset evaluation runners: KITTI (EPE + Fl-all) and Sintel (EPE).

Counterpart of ``opticalflow_tpu.evaluate``.  Mirrors
``inference_kitti.py:227-263`` (pad-to-/64, finest flow, upsample to GT
size, nanmean summaries) and the Sintel benchmark config from README:36
(clean 1.83 / final 2.31 for the canonical weights).

Evaluation batches pairs of one frame shape through one batched forward of
the engine instead of the reference's per-pair batch-1 loop, and the flow
upsampling runs on the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from opticalflow_tpu_torch.utils import metrics as M

__all__ = ["evaluate_pairs", "evaluate_kitti", "evaluate_sintel"]


def evaluate_pairs(engine, dataset, *, preset: str = "bgr_unit",
                   size_mode: str = "pad",
                   image_size=None,
                   batch: int = 8,
                   save_dir: Optional[str] = None,
                   save_format: str = "kitti_png",
                   limit: Optional[int] = None,
                   verbose: bool = True) -> Dict[str, float]:
    """Evaluate any dataset yielding {im1, im2, stem[, flow[, valid]]}.

    Pairs are grouped by frame shape and pushed through
    ``engine.flow_from_pairs`` ``batch`` at a time — one batched forward per
    chunk, with the final partial chunk padded to ``batch`` pairs (its extra
    outputs discarded), so every forward of a shape group has one shape.
    Per-pair metrics are unchanged from the reference semantics.  Build the
    engine with ``dispatch_chunk`` to bound the activation memory of a
    large ``batch``.  With a sharded engine (``mesh``), every rank is fed
    the same dataset, ``batch`` must be a multiple of the ranks, every rank
    returns the same metrics, and only rank 0 saves files and prints.

    ``size_mode``: "pad" is the corrected v2 pipeline (upsample-then-crop;
    see the documented divergence in ``FlowEngine.flow_from_pair``);
    "pad_ref" is the reference's exact ``inference_kitti.py:216-224`` order
    (unpad-quarter-then-rescale); "resize" replicates the distorting-resize
    convention of ``script_pwc.py``; "resize_fixed" is the v1
    ``inference.py`` script's PIL resize to the fixed ``image_size``.
    Returns {"epe": mean, "fl_all": mean%}
    (NaN-mean over pairs, like the reference).

    Samples STREAM through: a background thread fetches pairs into a
    bounded queue (host decode overlaps device compute) and each shape
    group's buffer is flushed — flow, metrics, optional save — as soon as
    it fills, so at most ~2·``batch`` samples are ever resident (the
    returned ``peak_resident`` records the max; the round-2 version
    materialized the whole dataset first, ~2.8 GB for Sintel clean)."""
    import os
    import queue as _queue
    import threading

    batch = max(1, int(batch))
    n = len(dataset) if limit is None else min(limit, len(dataset))
    mesh = getattr(engine, "mesh", None)
    if mesh is not None:
        if batch % mesh.world:
            raise ValueError(
                f"batch {batch} must be a multiple of the engine's "
                f"data-parallel width {mesh.world}")
        if mesh.rank:
            save_dir, verbose = None, False

    # ---- producer: fetch samples into a bounded queue (≤ batch waiting)
    q: "_queue.Queue" = _queue.Queue(maxsize=batch)
    resident = [0]          # fetched-but-unreleased samples (lock: count_lk)
    peak = [0]
    count_lk = threading.Lock()
    stop = threading.Event()    # set on consumer exit (incl. engine errors)
    # so the producer never blocks forever on a full queue

    def _put_guarded(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except _queue.Full:
                continue
        return False

    def _produce():
        # A dataset read error must reach the consumer: dying silently here
        # would leave the main thread parked on q.get() forever.  The
        # exception travels through the queue and is re-raised below,
        # matching the old materialize-first behavior (which raised inline).
        try:
            for i in range(n):
                if stop.is_set():
                    return
                s = dataset[i]
                with count_lk:
                    resident[0] += 1
                    peak[0] = max(peak[0], resident[0])
                if not _put_guarded((i, s)):
                    return
        except BaseException as exc:  # noqa: BLE001 — forwarded, not dropped
            _put_guarded(("error", exc))
            return
        _put_guarded(None)

    threading.Thread(target=_produce, daemon=True,
                     name="evaluate-producer").start()

    epe_by_i: Dict[int, float] = {}
    fl_by_i: Dict[int, float] = {}
    stem_by_i: Dict[int, str] = {}

    def _flush(buf):
        """Run one (possibly padded) batch and release its samples."""
        pad = buf + [buf[-1]] * (batch - len(buf))
        flows = engine.flow_from_pairs([s["im1"] for _, s in pad],
                                       [s["im2"] for _, s in pad],
                                       preset=preset, size_mode=size_mode,
                                       image_size=image_size)
        for k, (i, s) in enumerate(buf):
            flow = np.asarray(flows[k])
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                stem = s["stem"].replace("/", "_")
                if save_format == "flo":
                    from opticalflow_tpu_torch.io.flo import write_flo
                    write_flo(os.path.join(save_dir, f"{stem}.flo"), flow)
                else:
                    from opticalflow_tpu_torch.io.kitti import write_flow_png
                    write_flow_png(os.path.join(save_dir, f"{stem}.png"),
                                   flow)
            if "flow" in s:
                epe_by_i[i] = M.epe(flow, s["flow"], s.get("valid"))
                fl_by_i[i] = M.fl_all(flow, s["flow"], s.get("valid"))
                stem_by_i[i] = s["stem"]
        released = len(buf)
        buf.clear()
        with count_lk:
            resident[0] -= released

    # ---- consumer: per-shape buffers, flushed when full; total pending
    # capped at one batch (flush the fullest group early) so queue + pending
    # stays ≤ 2·batch even for adversarially interleaved shapes
    groups: Dict[tuple, list] = {}
    pending = 0
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if item[0] == "error":
                raise item[1]
            i, s = item
            buf = groups.setdefault(tuple(s["im1"].shape), [])
            buf.append((i, s))
            pending += 1
            if len(buf) == batch:
                _flush(buf)
                pending -= batch
            elif pending == batch:
                fullest = max(groups.values(), key=len)
                pending -= len(fullest)
                _flush(fullest)
        for buf in groups.values():
            if buf:
                _flush(buf)
    finally:
        # unblock the producer on any exit path (engine errors included):
        # without this an abandoned thread stays parked on the bounded
        # q.put, pinning a batch of decoded frames for the process lifetime
        stop.set()

    if verbose:
        for i in sorted(epe_by_i):
            print(f"{stem_by_i[i]} | EPE: {epe_by_i[i]:.3f} | "
                  f"Fl-all: {fl_by_i[i]:.2f}%")
    epes = [epe_by_i[i] for i in sorted(epe_by_i)]
    fls = [fl_by_i[i] for i in sorted(fl_by_i)]
    out = {
        "epe": float(np.nanmean(epes)) if epes else float("nan"),
        "fl_all": float(np.nanmean(fls)) if fls else float("nan"),
        "num_pairs": n,
        "peak_resident": peak[0],
    }
    if verbose:
        print("=" * 60)
        print(f"Mean EPE:    {out['epe']:.3f}")
        print(f"Mean Fl-all: {out['fl_all']:.2f}%")
    return out


def evaluate_kitti(engine, root: str, *, year: int = 2015,
                   flow_kind: str = "flow_occ", preset: str = "rgb_imagenet",
                   size_mode: str = "pad",
                   image_size=None,
                   batch: int = 8,
                   save_dir: Optional[str] = None,
                   limit: Optional[int] = None) -> Dict[str, float]:
    """KITTI sparse-GT evaluation (1242×375, replicate-pad to /64 by
    default; ``size_mode="pad_ref"`` for the reference's exact order)."""
    from opticalflow_tpu_torch.data.datasets import KittiPairsEval
    ds = KittiPairsEval(root, year=year, flow_kind=flow_kind)
    return evaluate_pairs(engine, ds, preset=preset, size_mode=size_mode,
                          image_size=image_size, batch=batch,
                          save_dir=save_dir, limit=limit)


def evaluate_sintel(engine, root: str, *, render: str = "clean",
                    preset: str = "bgr_unit",
                    batch: int = 8,
                    save_dir: Optional[str] = None,
                    limit: Optional[int] = None) -> Dict[str, float]:
    """MPI-Sintel clean/final EPE over the training split (dense GT);
    optionally dump predictions as Middlebury .flo files."""
    from opticalflow_tpu_torch.data.datasets import SintelPairs
    ds = SintelPairs(root, render=render)
    return evaluate_pairs(engine, ds, preset=preset, batch=batch,
                          save_dir=save_dir, save_format="flo", limit=limit)
