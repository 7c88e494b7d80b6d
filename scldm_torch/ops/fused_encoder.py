"""The VAE encoder's front half (input embedding, then the MCAB's LayerNorm,
key/value projections and pooled softmax attention) as hand-written CUDA
kernels, forward and backward, in two variants that share their math.

Counterpart of scldm_tpu/ops/fused_encoder.py: `encoder_pool` replaces the
Pallas `fused_encoder_pool` and `window_pool` the Pallas `fused_window_pool`,
each with its custom VJP. The kernels come in three designs, chosen by width:

- the reference encoder's (`SPECIALISED`: E = 32, 4 heads, 16 inducing
  points): `scldm_torch/kernels/csrc/encoder_pool.cu`, one source templated
  on where a token's embedding comes from (both variants below), both ways
  on the tensor cores: the forward a CTA of 16 warps per cell in two passes
  (the scores' row max, then the pooled sums against it), the backward over
  tiles of tokens and cells with a device workspace;
- every other narrow width (`narrow_kernel_takes`: E up to 128, any head
  count dividing E, any number of inducing points; both variants):
  `scldm_torch/kernels/csrc/encoder_pool_gen.cu`, on wgmma with TMA-fed
  shared memory: a warpgroup takes 64 tokens at a time, their LayerNorm and
  the k | v projection once for every head, the queries in tiles of 64 on
  the rows of the score and pooled-value products (any head width: each
  head's k16 steps and 8-column tiles), a cell's tokens split in chunks
  whose partials are added in order; the forward in two passes (the
  scores' max of each chunk, then e against the cell's max), the backward
  over a workspace that the library sizes (dq with the queries on the
  rows, dk and dv with the tokens on the rows, then per token the
  LayerNorm backward, then the weight gradients), every sum in a fixed
  order;
- wide (E a multiple of 64 from 256 to 1,024, head width 64, 1 to 1,024
  inducing points: the census encoder, E = 512 with 8 heads over 64, and the
  long-latent one over 1,024): `scldm_torch/kernels/csrc/window_pool_wide.cu`,
  the window variant only (JAX gates the dense pool at E <= 128), on the
  tensor cores, split over tokens, heads, queries and cells with a device
  workspace (`wide_kernel_takes` says which widths).

A shape none of them takes (a window E between 128 and 256, a wide E off
`wide_kernel_takes`) raises `ValueError` before any launch, never taking the
plain version on the card.

The two variants:

- dense (`encoder_pool`): token g of cell b is `table[g] * log1p(counts[b, g])`
  over every gene, so no (B, S, E) tensor and no gather. With the log1p
  transform a gene of count 0 has embedding exactly 0, so attention over the
  packed S-token window equals attention over all G genes minus `G - S`
  contributions of a zero-embedding row, one closed form (`_mcab_finish` in
  `training/vae_task.py` applies it);
- window (`window_pool`): token s of cell b is `emb[b, s]`, the gathered
  (B, S, E) input-layer output, padding rows included, as the module does.

Per token: affine LayerNorm, `k = x2 @ wk`, `v = x2 @ wv`, and per head h
and query i the score `s = scale * k[head h] . q[i, head h]`; per (cell,
query, head) the kernels stream the online-max softmax statistics and return
`(num, den, m)`, with `num / den` the attention output. `qfull` (Q*H, E) is
the JAX operand (`build_query_operand`: query i's head-h slice in head h's
column block of row h*Q + i); the kernels read only those blocks.

Layout: `den` and `m` are (B, Q*H), row h*Q + i as in JAX. `num` holds only
what `_mcab_finish` reads, the head-diagonal blocks of JAX's (B, Q*H, E):
`num[b, i, h*hd + d]` = JAX `num[b, h*Q + i, h*hd + d]`, shape (B, Q, E), the
layout of the attention output.

Rounding: the LayerNorm output (once per use), `wk`, `wv`, `k`, `qfull`, the
exponentials and `v` are rounded to bf16 before their products, which
accumulate in f32 (JAX `_ln_kv_scores`, `_online_update`). The plain
versions' autograd rounds the same cotangents to bf16 (the `_bf` idiom), as
JAX's in-kernel `jax.vjp` does; the CUDA backward rounds the reduced
gradients of `qfull`, `wk` and `wv` after the whole sum.

No padding: the kernels bounds-check ragged edges. So the zero-row
correction counts the zero rows the kernel streamed minus the window's:
`G - S` for the dense pool (JAX: its 1024-row padded gene axis minus S) and 0
for the window pool (JAX: its padded window minus S). Both sides compute the
same function; the port's backward differentiates exactly the rows its
forward streamed.

`m` is a statistic: it is returned marked non-differentiable, and each
backward recomputes the scores and exponentials given the saved `m` (JAX
`_numden_given_m`, the flash decomposition). Counts are data and get no
gradient. On CUDA tensors the wrappers launch the kernels (or raise); on CPU
tensors they run the plain versions; any other device raises. Each counts
its kernel launches, the wide design on counters of its own.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from scldm_torch.ops.fused_decoder import _bf
from scldm_torch.ops.fused_dit import LaunchCounter

#: weight order: ln1g (1, E), ln1b (1, E), wk (E, E), wv (E, E), (in, out)
WEIGHT_NAMES = ("ln1g", "ln1b", "wk", "wv")

#: (E, n_head, Q) of the specialised narrow design (encoder_pool.cu): the
#: reference encoder, E=32 with 4 cross heads over 16 inducing points
SPECIALISED = (32, 4, 16)
#: the widest E the other narrow design takes
MAX_NARROW_WIDTH = 128


def narrow_kernel_takes(E: int, n_head: int, Q: int) -> bool:
    """Whether the narrow kernels (both variants, both ways) take (E, n_head,
    Q): E from 1 to 128 with n_head dividing it and any number of inducing
    points (`scldm_encoder_pool_gen_takes` says the same). The JAX gates send
    every E <= 128 here."""
    return 1 <= E <= MAX_NARROW_WIDTH and n_head >= 1 and E % n_head == 0 and Q >= 1


def wide_kernel_takes(E: int, n_head: int, Q: int) -> bool:
    """Whether the wide window-pool kernels take (E, n_head, Q): E a multiple
    of 64 from 256 to 1,024 with heads of 64 (n_head = E / 64) and 1 to 1,024
    inducing points. That covers the census encoder
    (configs/model/vae_census.yaml: (512, 8, 64)), the E = 256 encoder of
    JAX's `tests/test_fused_encoder.py` and the long-latent encoder (Q =
    1,024); JAX's gate also lets through other head widths at E >= 256,
    which raise here."""
    return 256 <= E <= 1024 and n_head * 64 == E and 1 <= Q <= 1024


ENCODER_POOL_FWD_LAUNCHES = LaunchCounter()
ENCODER_POOL_BWD_LAUNCHES = LaunchCounter()
WINDOW_POOL_FWD_LAUNCHES = LaunchCounter()
WINDOW_POOL_BWD_LAUNCHES = LaunchCounter()
WINDOW_POOL_WIDE_FWD_LAUNCHES = LaunchCounter()
WINDOW_POOL_WIDE_BWD_LAUNCHES = LaunchCounter()


def build_query_operand(q16: torch.Tensor, n_head: int) -> torch.Tensor:
    """qfull (Q*H, E): row (h*Q + i) holds query i's head-h slice in head h's
    column block, zeros elsewhere. Differentiable."""
    Q, E = q16.shape
    hd = E // n_head
    q4 = q16.reshape(Q, n_head, hd).transpose(0, 1)  # (H, Q, hd)
    eye = torch.eye(n_head, dtype=q16.dtype, device=q16.device)
    return (q4[:, :, None, :] * eye[:, None, :, None]).reshape(n_head * Q, E)


def head_rows(x: torch.Tensor, n_head: int, hd: int) -> torch.Tensor:
    """(B, H*Q) per-(head, query) values -> (B, Q, E): value (h, i) repeated
    over head h's hd columns of query i's row, the layout of `num`."""
    B = x.shape[0]
    return x.reshape(B, n_head, -1).transpose(1, 2).repeat_interleave(hd, dim=-1)


def _bf_keep(t: torch.Tensor) -> torch.Tensor:
    """`_bf` that keeps f64: round to bf16 and back to f32, or to f64 where
    the plain version is evaluated in f64 (the wide kernels' yardstick). The
    same bits as `_bf` on f32 tensors."""
    return t.to(torch.bfloat16).to(torch.promote_types(t.dtype, torch.float32))


def _ln_kv_scores(x, qfull, weights, eps: float, scale: float):
    """LayerNorm, k/v projections and scaled per-head scores of (B, T, E)
    tokens (JAX `_ln_kv_scores`): -> s (B, T, Q*H), v (B, T, E)."""
    ln1g, ln1b, wk, wv = weights
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x2 = (x - mean) * torch.rsqrt(var + eps) * ln1g + ln1b
    k = _bf_keep(x2) @ _bf_keep(wk)
    v = _bf_keep(x2) @ _bf_keep(wv)
    return (_bf_keep(k) @ _bf_keep(qfull).t()) * scale, v


def _numden_given_m(s, v, m, n_head: int):
    """(num, den) of the tokens given the row max m (JAX `_numden_given_m`):
    num (B, Q, E), the head-diagonal blocks; den (B, Q*H)."""
    e = torch.exp(s - m[:, None, :])
    B, QH, E = s.shape[0], s.shape[2], v.shape[2]
    hd = E // n_head
    full = _bf_keep(e).transpose(1, 2) @ _bf_keep(v)  # (B, QH, E)
    num = torch.diagonal(full.reshape(B, n_head, QH // n_head, n_head, hd), dim1=1, dim2=3)
    return num.permute(0, 1, 3, 2).reshape(B, QH // n_head, E), e.sum(dim=1)


def _pool(emb, qfull, weights, n_head: int, eps: float):
    E = emb.shape[-1]
    s, v = _ln_kv_scores(emb, qfull, weights, eps, (E // n_head) ** -0.5)
    m = s.detach().amax(dim=1)
    return (*_numden_given_m(s, v, m, n_head), m)


def _dense_emb(counts, table):
    """Token g of cell b: table row g times log1p(count)."""
    return table[None] * torch.log1p(counts)[:, :, None]


def encoder_pool_reference(counts, table, qfull, weights, n_head: int = 4, eps: float = 1e-8):
    """Plain PyTorch version of the dense pool over every gene: (num (B, Q,
    E), den (B, Q*H), m (B, Q*H)), f32."""
    return _pool(_dense_emb(counts.float(), table), qfull, weights, n_head, eps)


def window_pool_reference(emb, qfull, weights, n_head: int = 4, eps: float = 1e-8):
    """Plain PyTorch version of the window pool over the (B, S, E) tokens,
    in f32 (in f64 for f64 inputs)."""
    return _pool(emb.to(torch.promote_types(emb.dtype, torch.float32)), qfull, weights, n_head,
                 eps)


def _check(variant: str, src, qfull, weights, n_head, counts=None, stats=()) -> Tuple[int, ...]:
    """Validate the kernels' operands; returns (B, N, E, Q) with N the token
    count (genes or window)."""
    QH, E = qfull.shape
    Q = QH // n_head
    if variant == "dense":
        N = src.shape[0]
        B = counts.shape[0]
        want = [("counts", counts, (B, N)), ("table", src, (N, E))]
    else:
        B, N = src.shape[0], src.shape[1]
        want = [("emb", src, (B, N, E))]
    want += [("ln1g", weights[0], (1, E)), ("ln1b", weights[1], (1, E)),
             ("wk", weights[2], (E, E)), ("wv", weights[3], (E, E))]
    want += list(zip(("m", "dnum", "dden"), stats, ((B, QH), (B, Q, E), (B, QH))))
    for name, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if variant == "window" and _wide(E):
        takes = wide_kernel_takes(E, n_head, Q)
        widths = "E a multiple of 64 in [256, 1024] with heads of 64 and 1 to 1,024 queries"
    else:
        takes = narrow_kernel_takes(E, n_head, Q)
        widths = f"E <= {MAX_NARROW_WIDTH} with n_head dividing it"
    if not takes or QH != n_head * Q:
        raise ValueError(f"the {variant}-pool kernels are built for {widths}, got "
                         f"({E}, {n_head}, {QH / n_head:g})")
    tensors = [src, qfull, *weights, *stats] + ([counts] if counts is not None else [])
    for t in tensors:
        if t.device != src.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "the encoder-pool kernels need contiguous float32 tensors on one device")
    if src.data_ptr() % 16:
        raise ValueError(f"the encoder-pool kernels read {variant} rows as 16-byte vectors")
    return B, N, E, Q


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the encoder pools run on cuda or cpu tensors, got {t.device}")
    return t.device.type


def _wide(E: int) -> bool:
    """The wide design takes the window pool at E >= 256."""
    return E >= 256


def _workspace(lib, B: int, N: int, E: int, n_head: int, Q: int, backward: bool, device):
    """The wide kernels' device workspace, sized by the library. It is freed
    on return; the caching allocator reuses it only after the launch, on the
    same stream."""
    floats = lib.scldm_window_pool_wide_workspace_floats(B, N, E, n_head, Q, int(backward))
    return torch.empty(floats, dtype=torch.float32, device=device)


def _gen_workspace(lib, B: int, N: int, E: int, n_head: int, Q: int, dense: bool,
                   backward: bool, device):
    """The any-width narrow kernels' device workspace, sized by the library:
    the bf16 operands (the weights, the queries and, backward, dnum's three
    bf16 parts) and the partial sums; backward also dk and dv of every token
    per 64-query tile in f32, and bf(x2), bf(dk) and bf(dv)."""
    floats = lib.scldm_encoder_pool_gen_workspace_floats(B, N, E, n_head, Q, int(dense),
                                                         int(backward))
    return torch.empty(floats, dtype=torch.float32, device=device)


def _launch(entry: str, src, qfull, weights, n_head: int, eps: float, counts=None):
    """Forward launch of either variant, in the design its width takes:
    (num, den, m)."""
    variant = "dense" if counts is not None else "window"
    B, N, E, Q = _check(variant, src, qfull, weights, n_head, counts)
    from scldm_torch.kernels import build

    lib = build.load()
    num = torch.empty((B, Q, E), dtype=torch.float32, device=src.device)
    den = torch.empty((B, n_head * Q), dtype=torch.float32, device=src.device)
    m = torch.empty_like(den)
    pointers = ([counts.data_ptr()] if counts is not None else []) + [src.data_ptr()]
    extra = []
    if _wide(E):
        entry = "scldm_window_pool_wide_forward"
        workspace = _workspace(lib, B, N, E, n_head, Q, False, src.device)
        extra = [workspace.data_ptr()]
    elif (E, n_head, Q) != SPECIALISED:
        entry = entry.replace("_pool_forward", "_pool_gen_forward")
        workspace = _gen_workspace(lib, B, N, E, n_head, Q, counts is not None, False, src.device)
        extra = [workspace.data_ptr()]
    # the library's CUDA runtime launches on the current device: make it src's
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        code = getattr(lib, entry)(
            *pointers, qfull.data_ptr(), *(w.data_ptr() for w in weights),
            num.data_ptr(), den.data_ptr(), m.data_ptr(), *extra,
            B, N, E, n_head, Q, eps, (E // n_head) ** -0.5, stream,
        )
    build.check(lib, code, f"{entry} launch")
    return num, den, m


def _launch_bwd(entry: str, src, qfull, weights, m, dnum, dden, n_head: int, eps: float,
                counts=None):
    """Backward launch of either variant: (dsrc, dqfull, dweights). Every
    design writes every gradient whole (dqfull's head-diagonal blocks, 0
    elsewhere), each summed in a fixed order through a device workspace that
    the library sizes: the narrow kernels add their CTAs' (or warps')
    partial sums (and, dense, the cell groups' dtable rows) in a last
    launch."""
    variant = "dense" if counts is not None else "window"
    dnum, dden = dnum.float().contiguous(), dden.float().contiguous()
    B, N, E, Q = _check(variant, src, qfull, weights, n_head, counts, (m, dnum, dden))
    from scldm_torch.kernels import build

    lib = build.load()
    if _wide(E):
        demb, dq = torch.empty_like(src), torch.zeros_like(qfull)
        dln = torch.empty((2, E), dtype=torch.float32, device=src.device)
        dw = torch.empty((E, 2 * E), dtype=torch.float32, device=src.device)
        workspace = _workspace(lib, B, N, E, n_head, Q, True, src.device)
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream(src.device).cuda_stream
            code = lib.scldm_window_pool_wide_backward(
                src.data_ptr(), qfull.data_ptr(), *(w.data_ptr() for w in weights),
                m.data_ptr(), dnum.data_ptr(), dden.data_ptr(), demb.data_ptr(), dq.data_ptr(),
                dln.data_ptr(), dw.data_ptr(), workspace.data_ptr(),
                B, N, E, n_head, Q, eps, (E // n_head) ** -0.5, stream,
            )
        build.check(lib, code, "scldm_window_pool_wide_backward launch")
        grads = (dq, dln[:1], dln[1:], dw[:, :E], dw[:, E:])
    else:
        dsrc = torch.empty_like(src)
        grads = [torch.empty_like(t) for t in (qfull, *weights)]
        if (E, n_head, Q) == SPECIALISED:
            workspace = torch.empty(
                lib.scldm_encoder_pool_workspace_floats(B, N, int(counts is not None)),
                dtype=torch.float32, device=src.device)
        else:
            entry = entry.replace("_pool_backward", "_pool_gen_backward")
            workspace = _gen_workspace(lib, B, N, E, n_head, Q, counts is not None, True,
                                       src.device)
        pointers = ([counts.data_ptr()] if counts is not None else []) + [src.data_ptr()]
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream(src.device).cuda_stream
            code = getattr(lib, entry)(
                *pointers, qfull.data_ptr(), *(w.data_ptr() for w in weights),
                m.data_ptr(), dnum.data_ptr(), dden.data_ptr(), dsrc.data_ptr(),
                *(g.data_ptr() for g in grads), workspace.data_ptr(),
                B, N, E, n_head, Q, eps, (E // n_head) ** -0.5, stream,
            )
        build.check(lib, code, f"{entry} launch")
        demb = dsrc
    dq, dln1g, dln1b, dwk, dwv = grads
    # qfull, wk and wv are rounded to bf16 before their products: their
    # gradients are rounded there too, after the whole sum
    return demb, _bf(dq), (dln1g, dln1b, _bf(dwk), _bf(dwv))


def _plain_grads(emb_fn, leaves, qfull, weights, m, dnum, dden, n_head: int, eps: float):
    """Autograd through the plain version given the saved m: the gradients of
    `leaves` (the tensors `emb_fn` reads), qfull and the weights."""
    inputs = [t.detach().requires_grad_() for t in (*leaves, qfull, *weights)]
    with torch.enable_grad():
        emb = emb_fn(*inputs[: len(leaves)])
        E = emb.shape[-1]
        s, v = _ln_kv_scores(emb, inputs[len(leaves)], inputs[len(leaves) + 1:], eps,
                             (E // n_head) ** -0.5)
        num, den = _numden_given_m(s, v, m, n_head)
        grads = torch.autograd.grad((num, den), inputs, (dnum, dden))
    return (*grads[: len(leaves)], grads[len(leaves)], tuple(grads[len(leaves) + 1:]))


def encoder_pool_backward_reference(counts, table, qfull, weights, m, dnum, dden,
                                    n_head: int = 4, eps: float = 1e-8):
    """Plain PyTorch version of the dense pool's backward (JAX `_fused_bwd`):
    autograd through the plain forward given the saved m -> (dtable, dqfull,
    (dln1g, dln1b, dwk, dwv))."""
    return _plain_grads(lambda t: _dense_emb(counts.float(), t), (table,), qfull, weights,
                        m, dnum, dden, n_head, eps)


def window_pool_backward_reference(emb, qfull, weights, m, dnum, dden,
                                   n_head: int = 4, eps: float = 1e-8):
    """Plain PyTorch version of the window pool's backward (JAX
    `_wfused_bwd`) -> (demb, dqfull, (dln1g, dln1b, dwk, dwv)), in f32 (in
    f64 for f64 inputs)."""
    return _plain_grads(lambda x: x.to(torch.promote_types(x.dtype, torch.float32)), (emb,),
                        qfull, weights, m, dnum, dden, n_head, eps)


def encoder_pool_fwd(counts, table, qfull, weights, n_head: int, eps: float):
    """Dense pool forward: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors. (num (B, Q, E), den (B, Q*H), m (B, Q*H))."""
    if _device_of(table) == "cpu":
        with torch.no_grad():
            return encoder_pool_reference(counts, table, qfull, weights, n_head, eps)
    out = _launch("scldm_encoder_pool_forward", table, qfull, weights, n_head, eps, counts)
    ENCODER_POOL_FWD_LAUNCHES.count += 1
    return out


def encoder_pool_bwd(counts, table, qfull, weights, m, dnum, dden, n_head: int, eps: float):
    """Dense pool backward given the saved m: (dtable, dqfull, (dln1g, dln1b,
    dwk, dwv)). The CUDA kernel writes the head-diagonal blocks of dqfull
    and leaves the rest 0, which `build_query_operand` masks out anyway."""
    if _device_of(table) == "cpu":
        return encoder_pool_backward_reference(counts, table, qfull, weights, m, dnum, dden,
                                               n_head, eps)
    out = _launch_bwd("scldm_encoder_pool_backward", table, qfull, weights, m, dnum, dden,
                      n_head, eps, counts)
    ENCODER_POOL_BWD_LAUNCHES.count += 1
    return out


def window_pool_fwd(emb, qfull, weights, n_head: int, eps: float):
    """Window pool forward: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. (num (B, Q, E), den (B, Q*H), m (B, Q*H))."""
    if _device_of(emb) == "cpu":
        with torch.no_grad():
            return window_pool_reference(emb, qfull, weights, n_head, eps)
    out = _launch("scldm_window_pool_forward", emb, qfull, weights, n_head, eps)
    (WINDOW_POOL_WIDE_FWD_LAUNCHES if _wide(emb.shape[-1]) else WINDOW_POOL_FWD_LAUNCHES).count += 1
    return out


def window_pool_bwd(emb, qfull, weights, m, dnum, dden, n_head: int, eps: float):
    """Window pool backward given the saved m: (demb, dqfull, (dln1g, dln1b,
    dwk, dwv)); dqfull as in `encoder_pool_bwd`."""
    if _device_of(emb) == "cpu":
        return window_pool_backward_reference(emb, qfull, weights, m, dnum, dden, n_head, eps)
    out = _launch_bwd("scldm_window_pool_backward", emb, qfull, weights, m, dnum, dden,
                      n_head, eps)
    (WINDOW_POOL_WIDE_BWD_LAUNCHES if _wide(emb.shape[-1]) else WINDOW_POOL_BWD_LAUNCHES).count += 1
    return out


class _EncoderPool(torch.autograd.Function):
    """The dense pool with a recompute VJP: it saves its inputs and m."""

    @staticmethod
    def forward(ctx, counts, table, qfull, ln1g, ln1b, wk, wv, n_head, eps):
        weights = (ln1g, ln1b, wk, wv)
        num, den, m = encoder_pool_fwd(counts, table, qfull, weights, n_head, eps)
        ctx.save_for_backward(counts, table, qfull, *weights, m)
        ctx.n_head, ctx.eps = n_head, eps
        ctx.mark_non_differentiable(m)
        return num, den, m

    @staticmethod
    def backward(ctx, dnum, dden, _dm):
        counts, table, qfull, *weights, m = ctx.saved_tensors
        dtable, dq, dws = encoder_pool_bwd(counts, table, qfull, weights, m, dnum, dden,
                                           ctx.n_head, ctx.eps)
        return (None, dtable, dq, *dws, None, None)


class _WindowPool(torch.autograd.Function):
    """The window pool with a recompute VJP: it saves its inputs and m."""

    @staticmethod
    def forward(ctx, emb, qfull, ln1g, ln1b, wk, wv, n_head, eps):
        weights = (ln1g, ln1b, wk, wv)
        num, den, m = window_pool_fwd(emb, qfull, weights, n_head, eps)
        ctx.save_for_backward(emb, qfull, *weights, m)
        ctx.n_head, ctx.eps = n_head, eps
        ctx.mark_non_differentiable(m)
        return num, den, m

    @staticmethod
    def backward(ctx, dnum, dden, _dm):
        emb, qfull, *weights, m = ctx.saved_tensors
        demb, dq, dws = window_pool_bwd(emb, qfull, weights, m, dnum, dden, ctx.n_head, ctx.eps)
        return (demb, dq, *dws, None, None)


def encoder_pool(
    counts: torch.Tensor,  # (B, G) dense counts: data, no gradient
    table: torch.Tensor,  # (G, E) gene-embedding rows 1..G
    qfull: torch.Tensor,  # (Q*H, E) block-diagonal per-head projected queries
    weights: Sequence[torch.Tensor],  # (ln1g (1, E), ln1b (1, E), wk (E, E), wv (E, E))
    n_head: int = 4,
    eps: float = 1e-8,
):
    """Dense pooling over every gene -> (num (B, Q, E), den (B, Q*H), m),
    differentiable in table, qfull and the weights: the forward kernel on
    the way in, the backward kernel on the way back (on CPU tensors, the
    plain version both ways). The caller applies the zero-row correction
    and divides num by den."""
    return _EncoderPool.apply(counts, table, qfull, *weights, n_head, eps)


def window_pool(
    emb: torch.Tensor,  # (B, S, E) gathered token embeddings (input-layer output)
    qfull: torch.Tensor,
    weights: Sequence[torch.Tensor],
    n_head: int = 4,
    eps: float = 1e-8,
):
    """Pooling over the packed (B, S, E) window -> (num, den, m) as
    `encoder_pool`, differentiable in emb, qfull and the weights. A bf16 emb
    (the input layer's under a bf16 compute dtype) is upcast here and its
    gradient returned in bf16, as JAX's kernel upcasts on load and casts
    demb back to emb's dtype; the kernels themselves take f32."""
    if emb.dtype == torch.bfloat16:
        emb = emb.float()
    return _WindowPool.apply(emb.contiguous(), qfull, *weights, n_head, eps)
