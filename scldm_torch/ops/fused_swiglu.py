"""The SwiGLU up projection and gate, alone and contracted with the
decoder's head vector, as hand-written CUDA kernels, forward and backward.

Counterpart of scldm_tpu/ops/fused_swiglu.py: `swiglu_vec` replaces the
Pallas `swiglu_vec` (`_vec_fwd_kernel`) with its custom VJP `_vec_fused_bwd`
(`_vec_bwd_kernel`), and `fused_swiglu_gate` the Pallas `fused_swiglu_gate`
(`_fwd_kernel`) with its custom VJP `_fused_bwd` (`_dx_kernel`,
`_dw_kernel`). `swiglu_vec` computes

    s = (silu(x @ w1) * (x @ w2)) @ wv    -> (R, 1) f32

for x (R, E), w12 = [w1 | w2] (E, 2Hd) and wv (Hd, 1), with no (R, Hd)
tensor in memory on the way in; the backward recomputes u = x @ w12 and
returns dx, dw12 and dwv. The kernels are in
`scldm_torch/kernels/csrc/swiglu_vec.cu`, on the tensor cores: the forward
keeps the up projection in registers and contracts it with wv in its
epilogue; the backward stages du through a workspace of at most
`SWIGLU_CHUNK` rows at a time and sums the weight gradients in a fixed
order, without atomics. The kernels read x and w12 through TMA, which needs
row pitches of 16 bytes: the wrappers hand over a padded copy where the
caller's are not.

`swiglu_vec` takes f32 or bf16 operands (x, w12 and wv of one dtype), and
the dtype picks the kernels. f32: wgmma with three TF32 passes a product,
f32-accurate. bf16 (the census decoder under a bf16 compute dtype, as JAX
hands its kernel bf16 operands): one bf16 wgmma pass, with JAX's rounding
points: the products bf16 x bf16 summed in f32, g rounded to bf16 before
`@ wv`; in the backward du rounded to bf16, dwv = bf(g)^T bf(ds), and dx,
dw12 and dwv returned in the operands' dtype (`swiglu_vec_reference`,
`swiglu_vec_backward_reference`). The output s is f32 in both.

`fused_swiglu_gate` computes the (R, H) gate itself,

    g = silu(x @ w1) * (x @ w2)    -> (R, H) in x's dtype (float32 here)

for x (R, E) and w1, w2 (E, H): its forward writes each gated tile where
`swiglu_vec`'s contracts it with wv, and its backward is `swiglu_vec`'s with
the cotangent dg (R, H) in place of ds * wv and no dwv. No JAX task
dispatches it (scldm_tpu/ops/fused_swiglu.py:17-19); nor does the port's.

On CUDA tensors each function launches its kernels (or raises on operands
they do not take: `fused_swiglu_gate` takes float32 only); on CPU
tensors it runs its plain version (`swiglu_vec_reference`,
`swiglu_reference`) both ways; any other device raises. Each direction
counts its kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scldm_torch.ops.fused_dit import LaunchCounter

SWIGLU_VEC_FWD_LAUNCHES = LaunchCounter()
SWIGLU_VEC_BWD_LAUNCHES = LaunchCounter()
SWIGLU_GATE_FWD_LAUNCHES = LaunchCounter()
SWIGLU_GATE_BWD_LAUNCHES = LaunchCounter()

# the backward's workspace (swiglu_vec.cu: kChunk, kSplit, kBM): du of one
# chunk of rows at a row pitch of a multiple of 4 floats, dw12's partials over
# SWIGLU_SPLIT slices of the rows, and swiglu_vec's dwv partials, one a
# 64-row tile of the chunk
SWIGLU_CHUNK = 32768
SWIGLU_SPLIT = 3
SWIGLU_ROW_TILE = 64


def _lanes(dtype: torch.dtype) -> int:
    """Values in 16 bytes: TMA's unit of row pitches and box starts."""
    return 8 if dtype == torch.bfloat16 else 4


def _pitch(n: int, dtype: torch.dtype = torch.float32) -> int:
    a = _lanes(dtype)
    return -(-n // a) * a


def swiglu_gate_workspace_floats(R: int, E: int, H: int) -> int:
    """Floats of the backward workspace of `fused_swiglu_gate` over R rows
    (the C entry `scldm_swiglu_gate_workspace_floats` states the same): du of
    one chunk and dw12's partials, both in the kernels' layout of w12 (2 H4
    columns, H4 = H rounded up to a multiple of 4)."""
    rows, h2 = min(R, SWIGLU_CHUNK), 2 * _pitch(H)
    return rows * h2 + SWIGLU_SPLIT * E * h2


def swiglu_vec_workspace_floats(R: int, E: int, Hd: int,
                                dtype: torch.dtype = torch.float32) -> int:
    """Floats of the backward workspace of `swiglu_vec` over R rows of
    `dtype` operands: du of one chunk in that dtype (2 H4 columns, H4 = Hd
    rounded up to 16 bytes), dw12's and dwv's partials in f32
    (`scldm_swiglu_vec_workspace_floats`, `scldm_swiglu_vec_bf16_workspace_floats`)."""
    rows, h2 = min(R, SWIGLU_CHUNK), 2 * _pitch(Hd, dtype)
    du = rows * h2 // 2 if dtype == torch.bfloat16 else rows * h2
    return du + SWIGLU_SPLIT * E * h2 + -(-rows // SWIGLU_ROW_TILE) * Hd


def _tma_operand(t: torch.Tensor) -> tuple:
    """(t, its row pitch) where its rows start 16 bytes apart, else a copy
    padded with zero columns to a pitch of 16 bytes."""
    width, a = t.shape[1], _lanes(t.dtype)
    if width % a == 0 and t.data_ptr() % 16 == 0:
        return t, width
    return F.pad(t, (0, -width % a)), _pitch(width, t.dtype)


def _tma_weights(w1: torch.Tensor, w2: torch.Tensor) -> tuple:
    """(w12, its row pitch) in the kernels' layout: w1 in columns [0, H), w2
    from column H4 = H rounded up to 16 bytes (zero columns between), so
    that every block starts 16 bytes into a row."""
    H = w1.shape[1]
    h4 = _pitch(H, w1.dtype)
    if h4 == H:
        return _tma_operand(torch.cat((w1, w2), dim=1))
    w12 = w1.new_zeros((w1.shape[0], 2 * h4))
    w12[:, :H] = w1
    w12[:, h4:h4 + H] = w2
    return w12, 2 * h4


def _vec_weights(w12: torch.Tensor, hd: int) -> tuple:
    if hd % _lanes(w12.dtype) == 0:
        return _tma_operand(w12)
    return _tma_weights(w12[:, :hd], w12[:, hd:])


def swiglu_vec_reference(x: torch.Tensor, w12: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (JAX `swiglu_vec_reference`): (R, 1) f32. The
    products sum in f32 (JAX's preferred_element_type) whatever the
    operands' dtype; g is rounded to that dtype before `@ wv`."""
    acc = torch.promote_types(x.dtype, torch.float32)
    u = x.to(acc) @ w12.to(acc)
    hd = wv.shape[0]
    g = F.silu(u[:, :hd]) * u[:, hd:]
    return g.to(x.dtype).to(acc) @ wv.to(acc)


def _vec_backward_bf16(x, w12, wv, ds):
    """The backward of bf16 operands with JAX's rounding points
    (`_vec_bwd_kernel`): u and the gate's derivative in f32, du rounded to
    bf16, the products bf16 x bf16 summed in f32, dwv = bf(g)^T bf(ds), each
    gradient returned in its operand's dtype."""
    bf, f32 = torch.bfloat16, torch.float32
    xf, wf = x.float(), w12.float()
    u = xf @ wf
    hd = wv.shape[0]
    u1, u2 = u[:, :hd], u[:, hd:]
    sg = torch.sigmoid(u1)
    silu = u1 * sg
    ds = ds.float()
    dg = ds * wv.float().t()
    du = torch.cat([dg * u2 * (sg + silu * (1.0 - sg)), dg * silu], dim=1).to(bf).to(f32)
    dx = (du @ wf.t()).to(x.dtype)
    dw12 = (xf.t() @ du).to(w12.dtype)
    dwv = ((silu * u2).to(bf).to(f32).t() @ ds.to(bf).to(f32)).to(wv.dtype)
    return dx, dw12, dwv


def swiglu_vec_backward_reference(x, w12, wv, ds):
    """Plain PyTorch version of the backward (JAX `_vec_fused_bwd`) ->
    (dx, dw12, dwv): autograd through `swiglu_vec_reference`, or, for bf16
    operands, JAX's rounding points written out (`_vec_backward_bf16`)."""
    if x.dtype == torch.bfloat16:
        with torch.no_grad():
            return _vec_backward_bf16(x, w12, wv, ds)
    leaves = [t.detach().requires_grad_() for t in (x, w12, wv)]
    with torch.enable_grad():
        out = swiglu_vec_reference(*leaves)
        return torch.autograd.grad(out, leaves, ds)


def _check(x, w12, wv, ds=None) -> tuple:
    """Validate the kernels' operands (x, w12 and wv all float32 or all
    bfloat16, ds float32); returns (R, E, Hd)."""
    R, E = x.shape
    hd = wv.shape[0]
    want = [("w12", w12, (E, 2 * hd)), ("wv", wv, (hd, 1))]
    if ds is not None:
        want.append(("ds", ds, (R, 1)))
    for name, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} for x {tuple(x.shape)}, got {tuple(t.shape)}")
    if E == 0 or hd == 0:
        raise ValueError(f"the swiglu_vec kernels need E >= 1 and Hd >= 1, got E={E}, Hd={hd}")
    for t in (x, w12, wv) + ((ds,) if ds is not None else ()):
        want = torch.float32 if t is ds else x.dtype
        if (t.device != x.device or t.dtype != want or not t.is_contiguous()
                or want not in (torch.float32, torch.bfloat16)):
            raise ValueError("the swiglu_vec kernels need contiguous tensors on one device: x, "
                             "w12 and wv all float32 or all bfloat16, ds float32")
    return R, E, hd


def _device_of(t: torch.Tensor, name: str = "swiglu_vec") -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {t.device}")
    return t.device.type


def swiglu_vec_fwd(x, w12, wv) -> torch.Tensor:
    """Forward: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors. (R, 1) f32."""
    if _device_of(x) == "cpu":
        with torch.no_grad():
            return swiglu_vec_reference(x, w12, wv)
    R, E, hd = _check(x, w12, wv)
    from scldm_torch.kernels import build

    lib = build.load()
    out = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    (xk, ldx), (wk, ldw) = _tma_operand(x), _vec_weights(w12, hd)
    entry = ("scldm_swiglu_vec_bf16_forward" if x.dtype == torch.bfloat16
             else "scldm_swiglu_vec_forward")
    # the library's CUDA runtime launches on the current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = getattr(lib, entry)(xk.data_ptr(), ldx, wk.data_ptr(), ldw, wv.data_ptr(),
                                   out.data_ptr(), R, E, hd, stream)
    build.check(lib, code, f"{entry} launch")
    SWIGLU_VEC_FWD_LAUNCHES.count += 1
    return out


def swiglu_vec_bwd(x, w12, wv, ds) -> tuple:
    """Backward given the cotangent ds (R, 1): (dx, dw12, dwv), each in its
    operand's dtype."""
    if _device_of(x) == "cpu":
        return swiglu_vec_backward_reference(x, w12, wv, ds)
    ds = ds.float().contiguous()
    R, E, hd = _check(x, w12, wv, ds)
    if R == 0:
        return torch.zeros_like(x), torch.zeros_like(w12), torch.zeros_like(wv)
    from scldm_torch.kernels import build

    lib = build.load()
    bf16 = x.dtype == torch.bfloat16
    f32 = dict(dtype=torch.float32, device=x.device)
    # dx in x's dtype; the kernels sum dw12 and dwv in f32, rounded below
    dx, dw12, dwv = torch.empty_like(x), torch.empty(w12.shape, **f32), torch.empty(wv.shape, **f32)
    tag = "_bf16" if bf16 else ""
    workspace = torch.empty(getattr(lib, f"scldm_swiglu_vec{tag}_workspace_floats")(R, E, hd),
                            **f32)
    (xk, ldx), (wk, ldw) = _tma_operand(x), _vec_weights(w12, hd)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = getattr(lib, f"scldm_swiglu_vec{tag}_backward")(
            xk.data_ptr(), ldx, wk.data_ptr(), ldw, wv.data_ptr(), ds.data_ptr(), dx.data_ptr(),
            dw12.data_ptr(), dwv.data_ptr(), workspace.data_ptr(), R, E, hd, stream)
    build.check(lib, code, f"scldm_swiglu_vec{tag}_backward launch")
    SWIGLU_VEC_BWD_LAUNCHES.count += 1
    return dx, dw12.to(w12.dtype), dwv.to(wv.dtype)


class _SwigluVec(torch.autograd.Function):
    """`swiglu_vec` with a recompute VJP: it saves only its inputs."""

    @staticmethod
    def forward(ctx, x, w12, wv):
        ctx.save_for_backward(x, w12, wv)
        return swiglu_vec_fwd(x, w12, wv)

    @staticmethod
    def backward(ctx, ds):
        return swiglu_vec_bwd(*ctx.saved_tensors, ds)


def swiglu_vec(
    x: torch.Tensor,  # (R, E)
    w12: torch.Tensor,  # (E, 2Hd): w1 | w2
    wv: torch.Tensor,  # (Hd, 1): the folded down projection @ head vector
) -> torch.Tensor:
    """(silu(x @ w1) * (x @ w2)) @ wv -> (R, 1) f32, differentiable in x, w12
    and wv: the forward kernel on the way in, the backward kernel on the way
    back (on CPU tensors, the plain version both ways). x, w12 and wv are all
    float32 or all bfloat16; the dtype picks the kernels."""
    return _SwigluVec.apply(x, w12, wv)


def swiglu_reference(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (JAX `swiglu_reference`): silu(x @ w1) * (x @ w2)
    in x's dtype."""
    u1, u2 = (x @ w1).float(), (x @ w2).float()
    return (F.silu(u1) * u2).to(x.dtype)


def swiglu_gate_backward_reference(x, w1, w2, dg):
    """Plain PyTorch version of the gate's backward (JAX `_fused_bwd`):
    autograd through `swiglu_reference` -> (dx, dw1, dw2)."""
    leaves = [t.detach().requires_grad_() for t in (x, w1, w2)]
    with torch.enable_grad():
        out = swiglu_reference(*leaves)
        return torch.autograd.grad(out, leaves, dg)


def _check_gate(x, w1, w2, dg=None) -> tuple:
    """Validate the gate kernels' operands; returns (R, E, H)."""
    R, E = x.shape
    H = w1.shape[1]
    want = [("w1", w1, (E, H)), ("w2", w2, (E, H))]
    if dg is not None:
        want.append(("dg", dg, (R, H)))
    for name, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} for x {tuple(x.shape)}, got {tuple(t.shape)}")
    if E == 0 or H == 0:
        raise ValueError(f"the fused_swiglu_gate kernels need E >= 1 and H >= 1, got E={E}, H={H}")
    for t in (x, w1, w2) + ((dg,) if dg is not None else ()):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "the fused_swiglu_gate kernels need contiguous float32 tensors on one device")
    return R, E, H


def swiglu_gate_fwd(x, w1, w2) -> torch.Tensor:
    """The gate's forward: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors. (R, H)."""
    if _device_of(x, "fused_swiglu_gate") == "cpu":
        with torch.no_grad():
            return swiglu_reference(x, w1, w2)
    R, E, H = _check_gate(x, w1, w2)
    from scldm_torch.kernels import build

    lib = build.load()
    out = torch.empty((R, H), dtype=torch.float32, device=x.device)
    # the kernels' operand: w1's and w2's columns side by side
    (xk, ldx), (wk, ldw) = _tma_operand(x), _tma_weights(w1, w2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.scldm_swiglu_gate_forward(xk.data_ptr(), ldx, wk.data_ptr(), ldw,
                                             out.data_ptr(), R, E, H, stream)
    build.check(lib, code, "scldm_swiglu_gate_forward launch")
    SWIGLU_GATE_FWD_LAUNCHES.count += 1
    return out


def swiglu_gate_bwd(x, w1, w2, dg) -> tuple:
    """The gate's backward given its cotangent dg (R, H): (dx, dw1, dw2), f32."""
    if _device_of(x, "fused_swiglu_gate") == "cpu":
        return swiglu_gate_backward_reference(x, w1, w2, dg)
    dg = dg.float().contiguous()
    R, E, H = _check_gate(x, w1, w2, dg)
    if R == 0:
        return torch.zeros_like(x), torch.zeros_like(w1), torch.zeros_like(w2)
    from scldm_torch.kernels import build

    lib = build.load()
    dx, dw12 = torch.empty_like(x), torch.empty((E, 2 * H), dtype=torch.float32, device=x.device)
    workspace = torch.empty(lib.scldm_swiglu_gate_workspace_floats(R, E, H), dtype=torch.float32,
                            device=x.device)
    (xk, ldx), (wk, ldw) = _tma_operand(x), _tma_weights(w1, w2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.scldm_swiglu_gate_backward(xk.data_ptr(), ldx, wk.data_ptr(), ldw,
                                              dg.data_ptr(), dx.data_ptr(), dw12.data_ptr(),
                                              workspace.data_ptr(), R, E, H, stream)
    build.check(lib, code, "scldm_swiglu_gate_backward launch")
    SWIGLU_GATE_BWD_LAUNCHES.count += 1
    return dx, dw12[:, :H], dw12[:, H:]


class _SwigluGate(torch.autograd.Function):
    """`fused_swiglu_gate` with a recompute VJP: it saves only its inputs."""

    @staticmethod
    def forward(ctx, x, w1, w2):
        ctx.save_for_backward(x, w1, w2)
        return swiglu_gate_fwd(x, w1, w2)

    @staticmethod
    def backward(ctx, dg):
        return swiglu_gate_bwd(*ctx.saved_tensors, dg)


def fused_swiglu_gate(
    x: torch.Tensor,  # (R, E)
    w1: torch.Tensor,  # (E, H)
    w2: torch.Tensor,  # (E, H)
) -> torch.Tensor:
    """silu(x @ w1) * (x @ w2) -> (R, H), differentiable in x, w1 and w2:
    the forward kernel on the way in, the backward kernel on the way back (on
    CPU tensors, the plain version both ways)."""
    return _SwigluGate.apply(x, w1, w2)
