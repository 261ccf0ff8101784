"""Spatial parallelism: flow inference of very large frames in H-tiles.

Counterpart of ``opticalflow_tpu.parallel.spatial``, with its geometry,
validation and messages, in the port's layout: frames (B, 6, H, W), quarter
flows (B, 2, H/4, W/4), the network's own units (no ×flow_scale).  The
image is split along H into overlapping tiles (halo = a receptive-field
margin), each tile runs the whole pyramid network, and the flows are
stitched back with the halos cropped.

Accuracy: a pyramid network's coarsest level sees nearly the whole frame,
so a tiled result is approximate near the seams (a 64-pixel halo: the JAX
package measured a median deviation of ~4e-3 network units and seam rows
up to ~0.04); a larger halo tightens it.  The image borders are exact: the
edge tiles and slabs slide inward so the true border sits at the window's
edge.

Two paths:

  * :func:`tiled_quarter_flow` recomputes the halos: every tile is a row of
    one batch; with a mesh the tile batch is split over the ranks (each
    runs its rows, an all-gather stitches them);
  * :func:`halo_exchange_quarter_flow` exchanges them: each rank holds only
    its own slab of H, receives 2·halo rows from each neighbour through the
    process group, and runs its extended slab.  The exchange is an
    all-gather of every rank's two boundary blocks: one path that NCCL and
    gloo (whose point-to-point ``send``/``recv`` takes host memory only)
    both carry.

The model must hold the same weights on every rank (``mesh.replicate`` it
once).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from opticalflow_tpu_torch.parallel import mesh as meshlib

__all__ = ["plan_tiles", "tiled_quarter_flow", "halo_exchange_quarter_flow"]


def plan_tiles(height: int, tile_h: int = 256,
               halo: int = 64) -> List[Tuple[int, int, int, int]]:
    """Split H into core tiles of ``tile_h`` with symmetric halos.

    Returns a list of (y0, y1, core0, core1): tile bounds in image rows and
    the core (owned) rows.  All values multiples of 64 except at the image
    borders where the halo is clipped.
    """
    if height % 64 or tile_h % 64 or halo % 64:
        raise ValueError("height, tile_h and halo must be multiples of 64")
    tiles = []
    y = 0
    while y < height:
        core0, core1 = y, min(y + tile_h, height)
        y0 = max(core0 - halo, 0)
        y1 = min(core1 + halo, height)
        tiles.append((y0, y1, core0, core1))
        y = core1
    return tiles


@torch.inference_mode()
def tiled_quarter_flow(model: torch.nn.Module, x: torch.Tensor, *,
                       tile_h: int = 256, halo: int = 64,
                       mesh: Optional[meshlib.Mesh] = None) -> torch.Tensor:
    """Quarter-resolution flow of (B, 6, H, W) via overlapping H-tiles.

    All tiles are stacked into one batch (a uniform tile height: pass a
    ``tile_h`` that divides H) and run as one forward; with a mesh the tile
    batch is split over the ranks, which must divide it.
    """
    b, _, h, _ = x.shape
    tiles = plan_tiles(h, tile_h, halo)
    span = max(y1 - y0 for y0, y1, _, _ in tiles)
    # uniform spans: re-extend the border tiles inward to `span` rows
    slices = []
    for (y0, y1, c0, c1) in tiles:
        if y1 - y0 < span:
            y0 = max(0, y1 - span) if y0 == 0 else y0
            y1 = y0 + span
            if y1 > h:
                y1, y0 = h, h - span
        slices.append((y0, y1, c0, c1))

    stacked = torch.cat([x[:, :, y0:y1] for (y0, y1, _, _) in slices])
    if mesh is None:
        q = model(stacked)
    else:
        n = mesh.world
        if stacked.shape[0] % n:
            # refusing beats silently running unsharded at 1/n throughput
            raise ValueError(
                f"tile batch {stacked.shape[0]} (= {len(slices)} tiles × "
                f"batch {b}) is not divisible by the {n}-device mesh — "
                f"pick tile_h so tiles×batch is a multiple of {n}, or "
                f"use halo_exchange_quarter_flow (shards H directly)")
        q = meshlib.all_gather_rows(
            model(meshlib.shard_batch(stacked, mesh)), mesh)
    # q: (T*B, 2, span/4, W/4)
    parts = []
    for t, (y0, y1, c0, c1) in enumerate(slices):
        q0 = (c0 - y0) // 4
        parts.append(q[t * b:(t + 1) * b, :, q0:q0 + (c1 - c0) // 4])
    return torch.cat(parts, dim=2)


@torch.inference_mode()
def halo_exchange_quarter_flow(model: torch.nn.Module, slab: torch.Tensor,
                               *, halo: int = 64,
                               mesh: Optional[meshlib.Mesh] = None
                               ) -> torch.Tensor:
    """Quarter-resolution flow of a frame whose H is split over the ranks.

    ``slab`` is this rank's contiguous slab (B, 6, H/n, W) of the frame
    (rank r holds rows r·H/n to (r+1)·H/n).  Each rank receives 2·halo
    rows from each neighbour through the process group, runs the network
    on a window of H/n + 2·halo rows, and keeps its slab's quarter rows;
    an all-gather hands every rank the whole (B, 2, H/4, W/4) flow.  The
    frame is held once across the ranks: the fit-anything path.

    Interior windows are centred on their slab (halo rows each side); rank
    0's window starts at its true top border and the last rank's ends at
    the true bottom border (2·halo rows from their one neighbour), so the
    image borders match the monolithic forward.  With one rank the result
    is the monolithic forward.

    Requires equal slabs of a /64 height, a /64 halo and a slab of at
    least 2·halo rows.
    """
    if mesh is None:
        raise ValueError("halo_exchange_quarter_flow requires a mesh")
    n, r = mesh.world, mesh.rank
    loc = slab.shape[2]
    shapes = meshlib.all_gather_rows(
        torch.tensor([list(slab.shape)], device=mesh.device), mesh)
    if not bool((shapes == shapes[0]).all()):
        raise ValueError(f"every rank must hold a slab of one shape; got "
                         f"{shapes.tolist()}")
    h = n * loc
    if loc % 64 or halo % 64:
        raise ValueError(
            f"H={h} must split into {n} slabs of a /64 height with a /64 "
            f"halo (got slab {loc}, halo {halo})")
    if n == 1:
        # one rank: the monolithic forward is the exact answer
        return meshlib.all_gather_rows(model(slab), mesh)
    two = 2 * halo
    if loc < two:
        raise ValueError(
            f"slab height {loc} must be ≥ 2·halo = {two} (edge devices "
            f"borrow a double halo from their single neighbor)")
    # every rank's (top, bottom) 2·halo-row blocks; rank r uses rank r-1's
    # bottom block and rank r+1's top one (the edge ranks' missing side is
    # never inside their window)
    blocks = meshlib.all_gather_rows(
        torch.stack([slab[:, :, :two], slab[:, :, loc - two:]]), mesh)
    from_above = blocks[2 * (r - 1) + 1] if r > 0 else torch.zeros_like(
        blocks[0])
    from_below = blocks[2 * (r + 1)] if r < n - 1 else torch.zeros_like(
        blocks[0])
    cat = torch.cat([from_above, slab, from_below], dim=2)
    # the window: centred for interior ranks, at the true borders for the
    # edge ranks
    start = two if r == 0 else (0 if r == n - 1 else halo)
    q = model(cat[:, :, start:start + loc + two])
    q0 = (two - start) // 4                 # the slab's origin in the window
    core = q[:, :, q0:q0 + loc // 4].contiguous()
    parts = meshlib.all_gather_rows(core.unsqueeze(0), mesh)
    return torch.cat(list(parts), dim=2)
