"""The VAE decoder tail (gene-query cross-attention, residual, LayerNorm,
SwiGLU and the NB head's mu logit) as hand-written CUDA kernels, forward and
backward.

Counterpart of scldm_tpu/ops/fused_decoder.py: `decoder_tail` replaces the
Pallas `fused_decoder_tail` with its custom VJP. The operands are the JAX
package's: batch-shared gene queries `qp` (normalised and projected) and `q`
(raw, the residual base), the block-diagonal per-head keys `kfull` and the
output-projected values `vproj` (`build_attention_operands`), and the packed
weights (`pack_weights`), in which `wv = wmlp @ wmu` folds the SwiGLU down
projection into the head's mu vector:

    logit[b, g] = wmu . h + (silu(hn w1) * (hn w2)) . wv + bmu,
    h = q[g] + attn(qp[g], kfull[b], vproj[b]),  hn = LN(h) * ln2g + ln2b

`kfull`, `qp`, the attention probabilities, `vproj`, `hn` and `w12` are
rounded to bf16 before their products, which accumulate in f32, as in the
JAX kernel. `decoder_tail_reference` is the plain PyTorch version, line for
line the JAX `_tail_math`; its autograd also rounds the gradients of those
six tensors to bf16, as JAX's does.

The kernels take every shape the JAX gate sends them (`kernel_takes`: E up
to 128, any head count dividing E, any number of latent tokens, any SwiGLU
hidden width), in two designs on the same math:

- the dentate decoder's (`SPECIALISED`: E = 32, 4 heads over 16 latent
  tokens; the backward at hidden width 88),
  `scldm_torch/kernels/csrc/decoder_tail.cu`, tuned for that shape;
- every other shape, `scldm_torch/kernels/csrc/decoder_tail_gen.cu`: wgmma
  with TMA-fed shared memory, the operands packed to bf16 once a launch (E
  padded to 64 or 128), the keys in tiles of 64, the backward in four
  kernels over a workspace (`decoder_tail_bwd_workspace_floats`) whose
  partials a fifth adds in a fixed order.

E past 128 (which the gate never sends) or a head count that does not
divide E raise `ValueError` before any launch; no shape quietly takes the
plain version on the card. `decoder_tail_fwd` and `decoder_tail_bwd` launch
the kernels on CUDA tensors and run the plain version on CPU tensors; any
other device raises. Each counts its kernel launches, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from scldm_torch.ops.fused_dit import LaunchCounter

#: packed weight order: ln2g (1, E), ln2b (1, E), w12 (E, 2Hd), wv (1, Hd),
#: wmu (1, E), bmu (1, 1)
WEIGHT_NAMES = ("ln2g", "ln2b", "w12", "wv", "wmu", "bmu")

#: (E, n_head, M) of the specialised design (decoder_tail.cu): the dentate-
#: gyrus decoder, E=32 with 4 cross heads over 16 latent tokens (the
#: reference config); its backward is built for the hidden width
#: `SPECIALISED_HIDDEN`, the dentate decoder's MLP(32)
SPECIALISED = (32, 4, 16)
SPECIALISED_HIDDEN = 88
#: the widest E the kernels take
MAX_WIDTH = 128
#: genes and cells a CTA of the specialised backward takes (kGenes, kCells in
#: decoder_tail.cu's namespace tail)
BWD_GENE_TILE, BWD_CELL_BLOCK = 64, 16


def kernel_takes(E: int, n_head: int, M: int, Hd: int) -> bool:
    """Whether the kernels take (E, n_head, M) with hidden width Hd, both
    ways: E from 1 to 128 with n_head dividing it, any number of latent
    tokens, any hidden width (`scldm_decoder_tail_gen_takes` says the same)."""
    return 1 <= E <= MAX_WIDTH and n_head >= 1 and E % n_head == 0 and M >= 1 and Hd >= 1


def specialised(E: int, n_head: int, M: int, Hd: int, backward: bool) -> bool:
    """Whether the shape runs on decoder_tail.cu's kernels (the forward at
    any hidden width, the backward at 88) rather than decoder_tail_gen.cu's."""
    return (E, n_head, M) == SPECIALISED and (not backward or Hd == SPECIALISED_HIDDEN)


DECODER_TAIL_FWD_LAUNCHES = LaunchCounter()
DECODER_TAIL_BWD_LAUNCHES = LaunchCounter()


def _bf(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32. The autograd of this pair rounds the
    incoming gradient to bf16 too, as JAX's `astype` into a bf16 dot does."""
    return t.to(torch.bfloat16).float()


def build_attention_operands(
    k: torch.Tensor,  # (B, M, E) cross-attention keys
    v: torch.Tensor,  # (B, M, E) cross-attention values
    wproj: torch.Tensor,  # (E, E) attention output projection, (in, out)
    n_head: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kfull, vproj), each (B, H*M, E) and contiguous: keys embedded in their
    head's column block, and values projected through their head's rows of
    `wproj`. Plain differentiable torch."""
    B, M, E = k.shape
    hd = E // n_head
    k4 = k.reshape(B, M, n_head, hd).transpose(1, 2)  # (B, H, M, hd)
    v4 = v.reshape(B, M, n_head, hd).transpose(1, 2)
    eye = torch.eye(n_head, dtype=k.dtype, device=k.device)
    kfull = (k4[:, :, :, None, :] * eye[None, :, None, :, None]).reshape(B, n_head * M, E)
    vproj = torch.einsum("bhmd,hde->bhme", v4, wproj.reshape(n_head, hd, E))
    return kfull.contiguous(), vproj.reshape(B, n_head * M, E).contiguous()


def pack_weights(
    ln2_scale: torch.Tensor,  # (E,)
    ln2_bias: torch.Tensor,  # (E,)
    w1: torch.Tensor,  # (E, Hd), (in, out)
    w2: torch.Tensor,  # (E, Hd)
    wmlp: torch.Tensor,  # (Hd, E)
    wmu: torch.Tensor,  # (E, 1)
    bmu: torch.Tensor,  # (1,)
) -> Tuple[torch.Tensor, ...]:
    """The kernels' weight tuple (WEIGHT_NAMES order), contiguous f32.
    Differentiable: gradients flow back through the concatenation and the
    `wv = wmlp @ wmu` contraction to the module's parameters."""
    E = w1.shape[0]
    return (
        ln2_scale.float().reshape(1, E).contiguous(),
        ln2_bias.float().reshape(1, E).contiguous(),
        torch.cat([w1, w2], dim=1).float().contiguous(),
        (wmlp.float() @ wmu.float().reshape(E, 1)).reshape(1, -1).contiguous(),
        wmu.float().reshape(1, E).contiguous(),
        bmu.float().reshape(1, 1).contiguous(),
    )


def decoder_tail_reference(
    qp: torch.Tensor,  # (G, E)
    q: torch.Tensor,  # (G, E)
    kfull: torch.Tensor,  # (B, H*M, E)
    vproj: torch.Tensor,  # (B, H*M, E)
    weights: Sequence[torch.Tensor],
    n_head: int,
    eps: float,
) -> torch.Tensor:
    """Plain PyTorch version of the tail (`_tail_math` in the JAX package):
    (B, G) f32 logits."""
    ln2g, ln2b, w12, wv, wmu, bmu = weights
    G, E = q.shape
    B, HM, _ = kfull.shape
    M = HM // n_head
    Hd = w12.shape[1] // 2
    scale = 1.0 / (E // n_head) ** 0.5

    s = _bf(kfull).reshape(B * HM, E) @ _bf(qp).t()  # (B*HM, G)
    p = torch.softmax(s.reshape(B * n_head, M, G) * scale, dim=1)
    y = _bf(p).reshape(B, HM, G).transpose(1, 2) @ _bf(vproj)  # (B, G, E)

    h = q[None].float() + y
    mean = h.mean(dim=-1, keepdim=True)
    var = (h - mean).square().mean(dim=-1, keepdim=True)
    hn = (h - mean) * torch.rsqrt(var + eps)
    hn = hn * ln2g.float() + ln2b.float()

    ab = _bf(hn).reshape(B * G, E) @ _bf(w12)
    a, b = ab[:, :Hd], ab[:, Hd:]
    g3 = (torch.nn.functional.silu(a) * b).reshape(B, G, Hd)
    mlp_logit = (g3 * wv.float()[None]).sum(dim=-1)
    return (h * wmu.float()[None]).sum(dim=-1) + mlp_logit + bmu[0, 0].float()


def _check(qp, q, kfull, vproj, weights, n_head) -> Tuple[int, int, int, int, int]:
    """Validate the kernels' operands; returns (B, G, E, M, Hd)."""
    G, E = qp.shape
    B, HM, _ = kfull.shape
    M = HM // n_head
    Hd = weights[2].shape[1] // 2
    want = [("q", q, (G, E)), ("kfull", kfull, (B, HM, E)), ("vproj", vproj, (B, HM, E)),
            ("ln2g", weights[0], (1, E)), ("ln2b", weights[1], (1, E)),
            ("w12", weights[2], (E, 2 * Hd)), ("wv", weights[3], (1, Hd)),
            ("wmu", weights[4], (1, E)), ("bmu", weights[5], (1, 1))]
    for name, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not kernel_takes(E, n_head, M, Hd) or HM != n_head * M:
        raise ValueError(
            f"the decoder-tail kernels are built for E <= {MAX_WIDTH} with n_head dividing it "
            f"and at least one latent token, got (E, n_head, M) = ({E}, {n_head}, "
            f"{HM / n_head:g})"
        )
    for t in (qp, q, kfull, vproj, *weights):
        if t.device != qp.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the decoder-tail kernels need contiguous float32 tensors on one device")
    if qp.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("the decoder-tail kernels read qp and q rows as 16-byte vectors")
    return B, G, E, M, Hd


def _wvec_floats(E: int, Hd: int) -> int:
    """dw12 and the vector gradients in one buffer, padded to a multiple of 4
    (`tail::wlen` in decoder_tail.cu; decoder_tail_gen.cu writes the first
    2E*Hd + 3E + Hd + 1)."""
    return -(-(2 * E * Hd + 3 * E + Hd + 1) // 4) * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _clamp(v: int, lo: int, hi: int) -> int:
    return lo if v < lo else hi if v > hi else v


def _gen_workspace_bytes(B: int, G: int, E: int, n_head: int, M: int, Hd: int,
                         backward: bool) -> int:
    """decoder_tail_gen.cu's workspace in bytes (`make_dims` and `carve` there;
    each piece 256-byte aligned): the packed bf16 operands (qp; kfull and
    vproj in head tiles, several heads to a 64-key tile where each has at most
    32 keys; E padded to 64 or 128; w12^T, its hidden rows padded to 32), then,
    backward, d(hh) (f32) and bf(hn) (bf16) of every pair, the softmax's row
    max, sum and D per (cell, head, gene) past 64 latent tokens, and the
    partials: per block of cells dqp of every gene, per rows CTA the vector
    sums, per gene chunk dvproj and dkfull's head blocks, per pair chunk dw12
    and dwv."""
    EP = 64 if E <= 64 else 128
    nkt, HdP, m16 = _cdiv(M, 64), 32 * _cdiv(Hd, 32), 16 * _cdiv(M, 16)
    hpt = 64 // m16 if nkt == 1 and m16 <= 32 else 1  # heads a 64-key tile
    HT, R = _cdiv(n_head, hpt), hpt * m16 if hpt > 1 else M
    nch, hd, P, BHM = HdP // 32, E // n_head, B * G, B * n_head * M
    n_gtr, n_gtq = _cdiv(G, 128), _cdiv(G, 64 * (3 if EP == 64 else 2))
    n_cb = _cdiv(B, _cdiv(B, _clamp(_cdiv(2112, n_gtr), 1, B)))
    n_cbq = _cdiv(B, _cdiv(B, _clamp(_cdiv(1056, n_gtq), 1, B)))
    n_gt = _cdiv(G, 64)
    n_gch = _cdiv(n_gt, _cdiv(n_gt, _clamp(_cdiv(1056, B * HT * nkt), 1, n_gt)))
    n_pt = _cdiv(P, 64)
    n_pc = _cdiv(n_pt, _cdiv(n_pt, _clamp(_cdiv(2112, nch), 1, n_pt)))
    pieces = [2 * G * EP, 2 * B * HT * R * EP, 2 * B * HT * R * EP, 2 * 2 * HdP * EP]
    if backward:
        pieces += [4 * P * EP, 2 * P * EP, 4 * 3 * B * n_head * G if nkt > 1 else 0,
                   4 * n_cbq * G * E, 4 * n_gtr * n_cb * (3 * E + 1), 4 * n_gch * BHM * E,
                   4 * n_gch * BHM * hd, 4 * n_pc * E * 2 * Hd, 4 * n_pc * Hd]
    return sum(-(-p // 256) * 256 for p in pieces)


def decoder_tail_fwd_workspace_floats(B: int, G: int, Hd: int, E: int = 32, n_head: int = 4,
                                      M: int = 16) -> int:
    """Device workspace of the forward, in floats: 0 for the specialised
    design, the packed operands for the other (the C entry
    `scldm_decoder_tail_gen_workspace_floats` says the same)."""
    if specialised(E, n_head, M, Hd, False) or B <= 0 or G <= 0:
        return 0
    return _gen_workspace_bytes(B, G, E, n_head, M, Hd, False) // 4


def decoder_tail_bwd_workspace_floats(B: int, G: int, Hd: int, E: int = 32, n_head: int = 4,
                                      M: int = 16) -> int:
    """Device workspace of the backward, in floats. The specialised design
    (`tail::workspace_floats` in decoder_tail.cu): the CTAs' partials, summed
    afterwards in a fixed order. Per cell block, dqp and dq of every gene
    (2GE); per gene tile and cell, dvproj (HM*E) and dkfull's head blocks
    (HM*HD); per CTA, dw12 and the vector gradients (2E*Hd + 3E + Hd + 1,
    padded to a multiple of 4); and those summed over the gene tiles, per
    cell block. The other design: `_gen_workspace_bytes`."""
    if not specialised(E, n_head, M, Hd, True):
        return _gen_workspace_bytes(B, G, E, n_head, M, Hd, True) // 4 if B > 0 and G > 0 else 0
    HM, HD = n_head * M, E // n_head
    n_gt = -(-G // BWD_GENE_TILE)
    n_cb = -(-B // BWD_CELL_BLOCK)
    nw = _wvec_floats(E, Hd)
    return n_cb * 2 * G * E + n_gt * B * HM * (E + HD) + n_gt * n_cb * nw + n_cb * nw


def _device_of(qp: torch.Tensor) -> str:
    if qp.device.type not in ("cuda", "cpu"):
        raise ValueError(f"decoder_tail runs on cuda or cpu tensors, got {qp.device}")
    return qp.device.type


def decoder_tail_fwd(qp, q, kfull, vproj, weights, n_head: int, eps: float) -> torch.Tensor:
    """Forward of the tail: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors. (B, G) f32 logits."""
    if _device_of(qp) == "cpu":
        with torch.no_grad():
            return decoder_tail_reference(qp, q, kfull, vproj, weights, n_head, eps)
    B, G, E, M, Hd = _check(qp, q, kfull, vproj, weights, n_head)
    from scldm_torch.kernels import build

    lib = build.load()
    out = torch.empty((B, G), dtype=torch.float32, device=qp.device)
    pointers = [qp.data_ptr(), q.data_ptr(), kfull.data_ptr(), vproj.data_ptr(),
                *(w.data_ptr() for w in weights), out.data_ptr()]
    shape = (B, G, E, n_head, M, Hd, eps, 1.0 / (E // n_head) ** 0.5)
    # the library's CUDA runtime launches on the current device: make it qp's
    with torch.cuda.device(qp.device):
        stream = torch.cuda.current_stream(qp.device).cuda_stream
        if specialised(E, n_head, M, Hd, False):
            code = lib.scldm_decoder_tail_forward(*pointers, *shape, stream)
        else:
            ws = torch.empty(lib.scldm_decoder_tail_gen_workspace_floats(B, G, E, n_head, M, Hd, 0),
                             dtype=torch.float32, device=qp.device)
            code = lib.scldm_decoder_tail_gen_forward(*pointers, ws.data_ptr(), *shape, stream)
    build.check(lib, code, "decoder_tail forward launch")
    DECODER_TAIL_FWD_LAUNCHES.count += 1
    return out


def decoder_tail_bwd(qp, q, kfull, vproj, weights, dy, n_head: int, eps: float):
    """Recompute-VJP of the tail: (dqp, dq, dkfull, dvproj, (dln2g, dln2b,
    dw12, dwv, dwmu, dbmu)). The CUDA kernels on CUDA tensors (they write the
    head blocks of dkfull and leave its off-block entries 0, which
    `build_attention_operands` masks out anyway; the weight gradients come
    back as views of one buffer); on CPU tensors the plain version's
    autograd."""
    if _device_of(qp) == "cpu":
        inputs = [t.detach().requires_grad_() for t in (qp, q, kfull, vproj, *weights)]
        with torch.enable_grad():
            out = decoder_tail_reference(*inputs[:4], inputs[4:], n_head, eps)
            grads = torch.autograd.grad(out, inputs, dy)
        return (*grads[:4], tuple(grads[4:]))
    B, G, E, M, Hd = _check(qp, q, kfull, vproj, weights, n_head)
    dy = dy.float().contiguous()
    if tuple(dy.shape) != (B, G) or dy.device != qp.device:
        raise ValueError(f"dy must be ({B}, {G}) on {qp.device}, got {tuple(dy.shape)}")
    from scldm_torch.kernels import build

    lib = build.load()
    qq = torch.empty((2, G, E), dtype=torch.float32, device=qp.device)  # dqp, dq
    dk = torch.zeros_like(kfull)  # the kernels write the head blocks only
    dv = torch.empty_like(vproj)
    wvec = torch.empty(_wvec_floats(E, Hd), dtype=torch.float32, device=qp.device)
    spec = specialised(E, n_head, M, Hd, True)
    floats = (decoder_tail_bwd_workspace_floats(B, G, Hd) if spec else
              lib.scldm_decoder_tail_gen_workspace_floats(B, G, E, n_head, M, Hd, 1))
    workspace = torch.empty(floats, dtype=torch.float32, device=qp.device)
    entry = lib.scldm_decoder_tail_backward if spec else lib.scldm_decoder_tail_gen_backward
    with torch.cuda.device(qp.device):
        stream = torch.cuda.current_stream(qp.device).cuda_stream
        code = entry(
            qp.data_ptr(), q.data_ptr(), kfull.data_ptr(), vproj.data_ptr(),
            *(w.data_ptr() for w in weights[:5]), dy.data_ptr(),
            qq.data_ptr(), dk.data_ptr(), dv.data_ptr(), wvec.data_ptr(), workspace.data_ptr(),
            B, G, E, n_head, M, Hd, eps, 1.0 / (E // n_head) ** 0.5, stream,
        )
    build.check(lib, code, "decoder_tail backward launch")
    DECODER_TAIL_BWD_LAUNCHES.count += 1
    n12 = E * 2 * Hd
    dw12 = wvec[:n12].view(E, 2 * Hd)
    dln2g, dln2b, dwmu = (wvec[n12 + i * E:n12 + (i + 1) * E].view(1, E) for i in range(3))
    dwv = wvec[n12 + 3 * E:n12 + 3 * E + Hd].view(1, Hd)
    dbmu = wvec[n12 + 3 * E + Hd:n12 + 3 * E + Hd + 1].view(1, 1)
    # the forward rounds qp, kfull, vproj and w12 to bf16 before their
    # products: their gradients are rounded there too, as the plain version's
    return _bf(qq[0]), qq[1], _bf(dk), _bf(dv), (dln2g, dln2b, _bf(dw12), dwv, dwmu, dbmu)


class _DecoderTail(torch.autograd.Function):
    """The tail with a recompute VJP: it saves only its inputs."""

    @staticmethod
    def forward(ctx, qp, q, kfull, vproj, ln2g, ln2b, w12, wv, wmu, bmu, n_head, eps):
        weights = (ln2g, ln2b, w12, wv, wmu, bmu)
        ctx.save_for_backward(qp, q, kfull, vproj, *weights)
        ctx.n_head, ctx.eps = n_head, eps
        return decoder_tail_fwd(qp, q, kfull, vproj, weights, n_head, eps)

    @staticmethod
    def backward(ctx, dy):
        qp, q, kfull, vproj, *weights = ctx.saved_tensors
        dqp, dq, dk, dv, dws = decoder_tail_bwd(qp, q, kfull, vproj, weights, dy,
                                                ctx.n_head, ctx.eps)
        return (dqp, dq, dk, dv, *dws, None, None)


def decoder_tail(
    qp: torch.Tensor,
    q: torch.Tensor,
    kfull: torch.Tensor,
    vproj: torch.Tensor,
    weights: Sequence[torch.Tensor],
    n_head: int = 4,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Decoder tail -> NB-head mu logits (B, G) f32, differentiable: the
    forward kernel on the way in, the backward kernel on the way back (on
    CPU tensors, the plain version both ways)."""
    return _DecoderTail.apply(qp, q, kfull, vproj, *weights, n_head, eps)
