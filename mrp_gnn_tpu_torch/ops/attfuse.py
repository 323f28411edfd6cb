"""AttFuse: per-pixel cross-robot attention with q = k = v = x and no
learned projection (OPV2V's ``AttFusion``, Xu et al., ICRA 2022), the
edge block of ``fusion="attfuse"`` (``models/fusion.AttFuse``).

For every pixel p and robot i of a map x [V, C, h, w]::

    y[i, :, p] = sum over j in S(i) of softmax_j(x[i, :, p] . x[j, :, p]
                 / sqrt(C)) x[j, :, p]

where S(i) is i itself and its graph neighbours, as a set (the graph
builders make no self loops and no repeated edges), over real robots: an
edge counts when both its ends are real, and a padded slot gets 0. A
robot with no neighbour gets its own map back.

Two routes, one autograd Function (:class:`AttFuseFunction`), so that
both record the same spans:

- plain torch (:func:`attfuse_reference`): per chunk of pixels, a dense
  attention over all V slots masked by S, from the edge list that every
  GraphBatch carries (any layout); its backward runs that forward again
  under autograd;
- the kernels of ``csrc/attfuse.cu`` for every CUDA ELL batch:
  :func:`graph_masks` builds the set's bit matrix and the tile flags,
  :func:`forward` the output and each row's log-sum-exp, :func:`backward`
  the whole input gradient dq + dk + dv (the source design note of
  ``csrc/attfuse.cu`` says why tiles of 64 nodes). They compute in
  float32: a bfloat16 map is copied to float32 on its way in and the
  result back. A width outside CHANNELS or more than MAX_NODES slots
  raises; such a batch never falls back to the plain form.

The route follows the layout alone: the plain form runs on the CPU and
for block-diagonal and plain edge-list batches. The kernels take the maps
pixel-major, [P, V, C]; :func:`attfuse` copies them there and back. The wrappers take CUDA tensors only (there is no CPU
mode) and count their launches in ``<wrapper>.launches``, read with the
other kernels' by ``bsp.launch_counts`` (``attfuse_graph``,
``attfuse_forward``, ``attfuse_backward``: two launches a call, the rows'
``gy . y`` and the gradient).

Tracing (``utils/profiling.py``): a launch span ``fusion.attfuse`` around
each forward launch, whose CUDA events the C entry records on the stream
right around the kernel (a device span around the plain forward on the
other route), the same ``fusion.attfuse_backward`` around the backward's
launches (the plain backward), and the counter ``fusion.attfuse_slots``: the
(destination slot, source slot, pixel) triples whose logit the call
computes, the real robots' own pairs left out. For the kernels that is
64 x 64 a flagged tile pair, counted on the device from the flags and
read when the recorder's snapshot is taken: no sync.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from mrp_gnn_tpu_torch.ops import _build
from mrp_gnn_tpu_torch.utils import profiling

CHANNELS = (16, 32, 64, 128)   # the widths csrc/attfuse.cu is built for
TILE = 64                      # nodes a tile (csrc/attfuse.cu kTile)
MAX_NODES = 16384              # the bit matrix: V x V / 8 bytes, 32 MB here
PLAIN_CHUNK = 1 << 24          # elements of a plain chunk's [p, V, V] logits
_LOG2E = 1.4426950408889634


@dataclasses.dataclass(frozen=True)
class Masks:
    """The set S of every row, for one route: ``mask`` [V, V] bool (row i:
    S(i), and every padded row itself, whose output is zeroed) for the
    plain form, or the kernels' bit matrix ``words`` [V, nt] int64 and tile
    flags ``tiles`` [2, nt, nt] uint8 (forward, and either way for the
    backward); ``node_mask`` [V] bool."""
    node_mask: torch.Tensor
    mask: torch.Tensor | None = None
    words: torch.Tensor | None = None
    tiles: torch.Tensor | None = None

    @property
    def kernel(self) -> bool:
        return self.words is not None


def dense_mask(graph, num_nodes: int) -> torch.Tensor:
    """[V, V] bool, row i: S(i) from the batch's edge list; a padded row
    holds itself alone (its output is zeroed), so that every softmax has
    a term."""
    nm = graph.node_mask
    src, dst = graph.edge_src.long(), graph.edge_dst.long()
    valid = graph.edge_mask & nm[src] & nm[dst]
    mask = torch.zeros(num_nodes, num_nodes, dtype=torch.bool,
                       device=nm.device)
    mask[dst[valid], src[valid]] = True
    return mask | torch.eye(num_nodes, dtype=torch.bool, device=nm.device)


def attfuse_reference(x: torch.Tensor, mask: torch.Tensor,
                      node_mask: torch.Tensor) -> torch.Tensor:
    """Plain version on the kernels' layout: x [P, V, C], ``mask`` as
    :func:`dense_mask`; returns y [P, V, C], padded rows 0. Computed in
    x's dtype, PLAIN_CHUNK logits at a time."""
    P, V, C = x.shape
    bias = torch.zeros(V, V, dtype=x.dtype, device=x.device).masked_fill(
        ~mask, float("-inf"))
    chunk = max(1, PLAIN_CHUNK // max(V * V, 1))
    out = []
    for lo in range(0, P, chunk):
        xc = x[lo:lo + chunk]
        logits = torch.matmul(xc, xc.transpose(1, 2)) / math.sqrt(C) + bias
        out.append(torch.matmul(torch.softmax(logits, dim=-1), xc))
    y = torch.cat(out) if len(out) > 1 else out[0]
    return y * node_mask[:, None].to(y.dtype)


def _check_cuda(kernel: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise RuntimeError(f"no {kernel} kernel for {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_maps(kernel: str, **maps) -> None:
    _check_cuda(kernel, **maps)
    shapes = {tuple(t.shape) for t in maps.values()}
    for name, t in maps.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[2] not in CHANNELS:
            raise ValueError(f"{name} must be [P, V, C] with C in "
                             f"{CHANNELS}, got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes")
    if len(shapes) != 1:
        raise ValueError(f"maps of different shapes: {sorted(shapes)}")


def graph_masks(ell_src: torch.Tensor, ell_mask: torch.Tensor,
                node_mask: torch.Tensor) -> Masks:
    """The kernels' masks of a CUDA ELL batch, one launch."""
    _check_cuda("attfuse_graph", ell_src=ell_src, ell_mask=ell_mask,
                node_mask=node_mask)
    if ell_src.dtype != torch.int32 or ell_mask.dtype != torch.bool \
            or node_mask.dtype != torch.bool:
        raise TypeError("ell_src must be int32, ell_mask and node_mask bool")
    V, deg = ell_src.shape
    if ell_mask.shape != (V, deg) or node_mask.shape != (V,):
        raise ValueError(f"ell_src {tuple(ell_src.shape)}, ell_mask "
                         f"{tuple(ell_mask.shape)} and node_mask "
                         f"{tuple(node_mask.shape)} do not fit")
    if not 0 < V <= MAX_NODES:
        raise ValueError(f"the kernels take 1 to {MAX_NODES} slots, got {V}")
    nt = -(-V // TILE)
    words = torch.zeros(V, nt, dtype=torch.int64, device=ell_src.device)
    tiles = torch.zeros(2, nt, nt, dtype=torch.uint8, device=ell_src.device)
    _build.run("attfuse", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
               + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p],
               ell_src.data_ptr(), ell_mask.data_ptr(), node_mask.data_ptr(),
               V, deg, words.data_ptr(), tiles[0].data_ptr(),
               tiles[1].data_ptr(), ell_src.device.index,
               _build.stream(ell_src), entry="attfuse_graph")
    graph_masks.launches += 1
    return Masks(node_mask=node_mask, words=words, tiles=tiles)


graph_masks.launches = 0


def forward(x: torch.Tensor, masks: Masks) -> tuple:
    """(y, lse) of x [P, V, C] f32 on the card: y as
    :func:`attfuse_reference`, lse [P, V] each row's log-sum-exp in log2
    units of the logits times log2(e) (-inf on a padded row), which the
    backward takes."""
    _check_maps("attfuse_forward", x=x)
    P, V, C = x.shape
    if masks.words.shape[0] != V:
        raise ValueError(f"x has {V} slots, the masks {masks.words.shape[0]}")
    y = torch.empty_like(x)
    lse = torch.empty(P, V, dtype=torch.float32, device=x.device)
    with profiling.launch_span("fusion.attfuse") as span:
        _build.run("attfuse", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p],
                   x.data_ptr(), y.data_ptr(), lse.data_ptr(),
                   masks.words.data_ptr(), masks.tiles[0].data_ptr(), P, V, C,
                   _LOG2E / math.sqrt(C), *span.handles(), x.device.index,
                   _build.stream(x), entry="attfuse_forward")
    forward.launches += 1
    return y, lse


forward.launches = 0


def backward(x: torch.Tensor, y: torch.Tensor, gy: torch.Tensor,
             lse: torch.Tensor, masks: Masks) -> torch.Tensor:
    """dx = dq + dk + dv of :func:`forward` for the output gradient gy, on
    the card: two launches."""
    _check_maps("attfuse_backward", x=x, y=y, gy=gy)
    P, V, C = x.shape
    delta = torch.empty(P, V, dtype=torch.float32, device=x.device)
    gx = torch.empty_like(x)
    with profiling.launch_span("fusion.attfuse_backward") as span:
        _build.run("attfuse", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p],
                   x.data_ptr(), y.data_ptr(), gy.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), gx.data_ptr(), masks.words.data_ptr(),
                   masks.tiles[1].data_ptr(), P, V, C, _LOG2E / math.sqrt(C),
                   1.0 / math.sqrt(C), *span.handles(), x.device.index,
                   _build.stream(x), entry="attfuse_backward")
    backward.launches += 2
    return gx


backward.launches = 0


def _count_slots(masks: Masks, pixels: int) -> None:
    """The counter ``fusion.attfuse_slots`` of one call (a device tensor
    on the card, read at the recorder's snapshot)."""
    if not profiling.enabled():
        return
    real = masks.node_mask.sum()
    pairs = (masks.tiles[0].sum() * (TILE * TILE) if masks.kernel
             else masks.node_mask.shape[0] ** 2)
    profiling.count("fusion.attfuse_slots", (pairs - real) * pixels)


class AttFuseFunction(torch.autograd.Function):
    """AttFuse on x [P, V, C] with ``masks`` (:class:`Masks`): the kernels
    where ``masks`` holds theirs, the plain form otherwise."""

    @staticmethod
    def forward(ctx, x, masks: Masks):
        _count_slots(masks, x.shape[0])
        if masks.kernel:
            y, lse = forward(x, masks)
        else:
            with profiling.span("fusion.attfuse", device=True):
                y = attfuse_reference(x, masks.mask, masks.node_mask)
            lse = None
        ctx.masks = masks
        ctx.save_for_backward(x, y, lse)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, y, lse = ctx.saved_tensors
        masks = ctx.masks
        if masks.kernel:
            return backward(x, y, gy.contiguous(), lse, masks), None
        with profiling.span("fusion.attfuse_backward", device=True), \
                torch.enable_grad():
            xr = x.detach().requires_grad_()
            yr = attfuse_reference(xr, masks.mask, masks.node_mask)
            gx, = torch.autograd.grad(yr, xr, gy)
        return gx, None


def attfuse(x: torch.Tensor, graph, kernels: bool) -> torch.Tensor:
    """AttFuse of the map x [V, C, h, w] over ``graph``: y [V, C, h, w] in
    x's dtype, padded slots 0. ``kernels``: the kernels on a CUDA ELL batch
    (in float32), the plain form otherwise."""
    V, C, h, w = x.shape
    xt = x.permute(2, 3, 0, 1).reshape(h * w, V, C).contiguous()
    if kernels and x.device.type == "cuda" and graph.ell_src is not None:
        masks = graph_masks(graph.ell_src, graph.ell_mask, graph.node_mask)
        yt = AttFuseFunction.apply(xt.float(), masks).to(x.dtype)
    else:
        masks = Masks(node_mask=graph.node_mask, mask=dense_mask(graph, V))
        yt = AttFuseFunction.apply(xt, masks)
    return yt.reshape(h, w, V, C).permute(2, 3, 0, 1).contiguous()
