"""VAE training task (counterpart of scldm_tpu/training/vae_task.py): the NB
(or Gaussian) reconstruction loss, the training step (loss, backward, global-norm clip,
AdamWLegacy on the wsd schedule) and the validation metrics.

On the lean wire batch (expressed genes and counts only, uint16) the step
decodes every gene through the fused decoder tail
(`ops/fused_decoder.decoder_tail`: hand-written CUDA kernels, forward and
backward, on a GPU), as the JAX task does on a TPU; otherwise it runs the
plain module path. Where the gene axis is about as long as the token window
(parse1m / replogle shapes, G = S = 2,000) that path also pools the encoder's
input over the dense gene axis (`fused_encoder_pooling`: the dense encoder
pool kernels), exactly where JAX does; `VAETask(fused_pool=True)` pools the
packed window through the window pool kernels instead (`fused_window_pooling`).
At E > 128 (the census decoder, E = 512), where JAX leaves its tail, the step
takes the algebraic tail (`algebraic_nb_apply`): the cross block and the NB
head reassociated in plain PyTorch, with `VAETask(algebraic_fused_gate=True)`
running the SwiGLU up projection, gate and head-vector contraction as the
`ops/fused_swiglu.swiglu_vec` kernels. `VAETask(fused_trunk=True)` (off
unless asked, as in JAX) runs both trunks of that kernel path, the encoder's
and the decoder's blocks, as the whole-trunk kernels
(`ops/fused_trunk.fused_trunk_blocks_trainable`).

The kernel paths are taken where JAX's gates hold, read from the modules:
any input layer (`agg_func`) reaches the tail, the window pool and the
trunk, the dense pool only under log1p; dropout, the decoder's own gene
embedding and a head other than the shared-theta NB close the tail (and
dropout every gate), so those variants train on the module path, as in JAX.

Under a bf16 compute dtype (`vae.decoder.dtype`) the paths keep JAX's
boundaries: the modules compute in bf16; the dense pool's operands and its
MCAB finish, the decoder tail's operands (rows 3-6) stay f32; the window
pool and the whole trunk take the bf16 embedding or activations and compute
in f32 inside, returning their outputs and input gradients in bf16; the
algebraic tail casts to bf16 where JAX's does, and its `swiglu_vec` takes
bf16 operands.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from scldm_torch.nn.heads import GaussianTransformerHead, NegativeBinomialTransformerHead
from scldm_torch.nn.layers import (
    Drops,
    LayerNormFP32,
    column,
    column_input,
    silu,
    table,
    weights,
)
from scldm_torch.nn.vae import TransformerVAE
from scldm_torch.ops.attention import sdpa_shared_q
from scldm_torch.ops.distributions import log_gaussian, log_nb_positive, nb_sample
from scldm_torch.ops.fused_decoder import _bf, build_attention_operands, decoder_tail, pack_weights
from scldm_torch.ops.fused_encoder import build_query_operand, encoder_pool, head_rows, window_pool
from scldm_torch.ops.fused_swiglu import swiglu_vec
from scldm_torch.ops.fused_trunk import (
    extract_trunk_params,
    fused_trunk_blocks_trainable,
    trunk_kernel_ok,
)
from scldm_torch.ops.transforms import (
    COUNTS,
    COUNTS_SUBSET as C_SUB,
    GENES,
    GENES_SUBSET as G_SUB,
    LIBRARY_SIZE as LIB,
    canonical_gene_ids,
    densify_expressed,
    log1p_cpm,
    widen_lean,
)
from scldm_torch.parallel.data_parallel import (
    Layout,
    full_weights,
    step_gradients,
    trained_params,
)
from scldm_torch.parallel.gene_sp import GeneSP
from scldm_torch.parallel.mesh import axis_size
from scldm_torch.training import metrics as M
from scldm_torch.training.optim import AdamWLegacy, wsd_schedule
from scldm_torch.training.state import TrainState, create_train_state


def _nb_tail_ok(vae: TransformerVAE) -> bool:
    """What the tails (`fused_nb_apply`, `algebraic_nb_apply`) assume of the
    decoder, as JAX's gates: the shared-theta NB head, the shared gene
    embedding (the tails read the input layer's table as their queries), no
    adaLN, no dropout and no qkv bias (the tails omit it)."""
    head, dec = vae.decoder_head, vae.decoder
    ca = dec.decoder_cross_attention
    return (
        isinstance(head, NegativeBinomialTransformerHead)
        and head.shared_theta
        and dec.shared_embedding
        and not ca.use_adaln
        and dec.dropout == 0.0
        and ca.attn.c_attn.bias is None
    )


def _fused_path_ok(vae: TransformerVAE) -> bool:
    """Whether `fused_nb_apply` computes what the module path computes: the
    JAX gate, `_nb_tail_ok` at E <= 128 (at E > 128 the JAX task leaves the
    tail for its algebraic path). Any input layer, with or without the
    encoder's positional table: the tail reads only the decoder and the head.
    The CUDA kernels take every width this gate passes, at any number of
    latent tokens (`ops/fused_decoder.kernel_takes`); a shape they did not
    take would raise at launch, never quietly take the module path instead."""
    return _nb_tail_ok(vae) and vae.decoder.n_embed <= 128


def _fused_encoder_ok(vae: TransformerVAE) -> bool:
    """The JAX gate of the dense encoder pool: embeddings that vanish at count
    0 (`agg_func: log1p` alone; the pool's closed form takes the G - S
    zero-count rows out as zero embeddings), no dropout, no qkv bias (the
    kernels omit it) and E <= 128. The CUDA kernels take every such width, at
    any number of inducing points (`ops/fused_encoder.narrow_kernel_takes`)."""
    enc = vae.encoder
    ca = enc.ca_layer
    return (vae.input_layer.agg_func == "log1p" and enc.dropout == 0.0
            and ca.attn.c_attn.bias is None and enc.n_embed <= 128)


def _fused_window_ok(vae: TransformerVAE) -> bool:
    """The JAX gate of the window pool: any input layer (the kernels take
    the embedded window), no dropout, no qkv bias, and E at one of the JAX
    kernel's two validated tile geometries (E <= 128 or E >= 256). The CUDA
    kernels take every narrow width at any number of inducing points
    (`ops/fused_encoder.narrow_kernel_takes`) and the wide design's
    (`ops/fused_encoder.wide_kernel_takes`: heads of 64 at E from 256 to
    1,024, up to 1,024 inducing points); another wide shape passes this gate
    and raises at launch."""
    enc = vae.encoder
    E = enc.n_embed
    return (enc.dropout == 0.0 and enc.ca_layer.attn.c_attn.bias is None
            and (E <= 128 or E >= 256))


def _fused_trunk_ok(vae: TransformerVAE) -> bool:
    """The JAX gate of the whole-trunk kernel on both block stacks
    (`trunk_kernel_ok`: no bias, no dropout, no adaLN, E <= 128, and no
    remat), read from the blocks, which also must have affine LayerNorms.
    Any input layer: the kernel takes the pooled tokens. A width the CUDA
    kernels do not take passes this gate and raises at launch."""
    enc, dec = vae.encoder.encoder_layers, vae.decoder.decoder_layers
    if vae.encoder.remat or vae.decoder.remat:
        return False
    return len(enc) > 0 and len(dec) > 0 and all(
        trunk_kernel_ok(b.ln_1.n, b.attn.c_attn.bias is not None, b.attn.dropout, b.use_adaln)
        and b.ln_1.weight is not None
        for b in (*enc, *dec)
    )


def _encoder_trunk_tail(vae: TransformerVAE, pooled: torch.Tensor) -> torch.Tensor:
    """The encoder after its MCAB pooling (JAX `_encoder_trunk_tail`): the
    blocks as the whole-trunk kernel, then the latent projection and the
    non-affine LN. The frozen all-zeros `pos_embed` is not added, as JAX
    leaves it out: adding zeros is exact either way. The pooled tokens enter
    in the compute dtype, as JAX's `pooled.astype(dt)`."""
    enc = vae.encoder
    blocks = enc.encoder_layers
    h = fused_trunk_blocks_trainable(pooled.to(enc.dtype), extract_trunk_params(blocks),
                                     blocks[0].attn.n_head, blocks[0].ln_1.eps)
    return enc.encoder_latent_input(h)


def _decoder_trunk(vae: TransformerVAE, h_z: torch.Tensor) -> torch.Tensor:
    """The decoder before its cross block (JAX `_decoder_trunk`): the
    non-affine LN and the latent projection, then the blocks as the
    whole-trunk kernel."""
    dec = vae.decoder
    blocks = dec.decoder_layers
    return fused_trunk_blocks_trainable(dec.decoder_latent_input(h_z),
                                        extract_trunk_params(blocks), blocks[0].attn.n_head,
                                        blocks[0].ln_1.eps)


def _dense_pool_worth_it(n_genes: int, window_len: int) -> bool:
    """JAX's dispatch ratio, kept as it is so that the port pools densely
    exactly where JAX does: the dense pool does (padded G / S) times the
    window's token work; JAX takes it when its 1024-row padded gene axis is
    at most 1.3 times the window (tuned on a TPU: parse1m / replogle, G = S =
    2,000, pass; dentate, G = 17,002 over S = 6,147, does not)."""
    g_padded = n_genes + ((-n_genes) % min(1024, n_genes))
    return g_padded <= int(1.3 * window_len)


def _mcab_prep(vae: TransformerVAE):
    """The pools' shared operands from the encoder's MCAB: the raw inducing
    points, the block-diagonal query operand and the weight tuple (ln1g,
    ln1b, wk, wv), (in, out) views of the module's parameters."""
    ca = vae.encoder.ca_layer
    E = ca.ln_1.n
    inducing = ca.inducing_points.float()  # (Q, E)
    # f32 whatever the compute dtype, as JAX's raw-parameter prep
    qfull = build_query_operand(ca.attn.c_attn_q(ca.ln_1q(inducing), torch.float32),
                                ca.attn.n_head)
    wk, wv = ca.attn.c_attn.weight.t().chunk(2, dim=1)
    weights = (ca.ln_1.weight.reshape(1, E), ca.ln_1.bias.reshape(1, E),
               wk.contiguous(), wv.contiguous())
    return inducing, qfull.contiguous(), weights


def _mcab_finish(ca, inducing, qfull, weights, num, den, m, corr: int) -> torch.Tensor:
    """The MCAB after the pool (JAX `_mcab_finish`): the closed-form
    correction of `corr` zero-embedding rows, num / den, the output
    projection, the residual on the raw inducing points, then ln_2 and the
    SwiGLU, in f32 whatever the compute dtype (JAX's raw-parameter math).
    `num` holds the head-diagonal blocks, (B, Q, E)."""
    n_head = ca.attn.n_head
    E = num.shape[-1]
    hd = E // n_head
    if corr:
        # a zero embedding: LN(0) = ln1b, then the kernels' rounding points
        x0 = weights[1]
        k0 = _bf(x0) @ _bf(weights[2])
        v0 = _bf(x0) @ _bf(weights[3])
        s0 = (_bf(k0) @ _bf(qfull).t()) * hd**-0.5  # (1, Q*H)
        e0 = torch.exp(s0 - m)  # (B, Q*H)
        den = den - corr * e0
        num = num - corr * head_rows(e0, n_head, hd) * v0
    f32 = torch.float32
    y = ca.attn.c_proj(num / head_rows(den, n_head, hd), f32)
    out = inducing[None] + y
    return out + ca.mlp(ca.ln_2(out), f32)


def fused_encoder_pooling(vae: TransformerVAE, counts_dense: torch.Tensor,
                          window_len: int) -> torch.Tensor:
    """The encoder's input embedding and MCAB pooling over the dense gene
    axis (`ops/fused_encoder.encoder_pool`) -> the pooled (B, M, E) tokens,
    as `vae.encoder.ca_layer(vae.input_layer(...))` over the packed window of
    `window_len` tokens. The kernel streams all G genes: the window holds
    S - nnz zero-embedding rows and the gene axis G - nnz, so G - S of them
    are taken out in closed form (JAX: its padded gene axis minus S; the same
    function). log1p input only."""
    inducing, qfull, weights = _mcab_prep(vae)
    ca = vae.encoder.ca_layer
    table = vae.input_layer.gene_embedding.weight[1:]  # canonical genes 1..G
    num, den, m = encoder_pool(counts_dense.float(), table, qfull, weights, ca.attn.n_head,
                               ca.ln_1.eps)
    return _mcab_finish(ca, inducing, qfull, weights, num, den, m,
                        counts_dense.shape[1] - window_len)


def fused_window_pooling(vae: TransformerVAE, emb: torch.Tensor) -> torch.Tensor:
    """MCAB pooling of the packed (B, S, E) window (`vae.input_layer`'s
    output) through `ops/fused_encoder.window_pool` -> (B, M, E). Padding
    rows inside the window are real tokens, as in the module; the kernel
    pads nothing, so nothing is corrected (JAX: its padded window minus S)."""
    inducing, qfull, weights = _mcab_prep(vae)
    ca = vae.encoder.ca_layer
    num, den, m = window_pool(emb, qfull, weights, ca.attn.n_head, ca.ln_1.eps)
    return _mcab_finish(ca, inducing, qfull, weights, num, den, m, 0)


def fused_nb_apply(
    vae: TransformerVAE, batch: Dict, batch_chunk: Optional[int] = None, use_trunk: bool = False
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """`TransformerVAE.forward` with the decoder's cross block and the NB
    head's mu logit as the fused tail, over the canonical gene list 1..G;
    where JAX's gate holds (`_fused_encoder_ok`, `_dense_pool_worth_it`) the
    encoder's input embedding and MCAB pooling are the dense pool. The
    encoder's and the decoder's trunks run as modules, or, with `use_trunk`
    where `_fused_trunk_ok` holds, as the whole-trunk kernel (JAX's opt-in,
    on both branches of the encoder); no (B, G, E) tensor is formed.
    `batch_chunk` splits the tail into launches over batch slices of that
    size. Differentiable end to end. Returns ({"mu", "theta"}, h_z)."""
    use_trunk = bool(use_trunk) and _fused_trunk_ok(vae)
    if (
        _fused_encoder_ok(vae)
        and COUNTS in batch
        and G_SUB in batch
        and _dense_pool_worth_it(batch[COUNTS].shape[1], batch[G_SUB].shape[1])
    ):
        pooled = fused_encoder_pooling(vae, batch[COUNTS], batch[G_SUB].shape[1])
        h_z = _encoder_trunk_tail(vae, pooled) if use_trunk else vae.encoder.trunk(pooled)
    else:
        emb = vae.input_layer(batch[C_SUB], batch[G_SUB])
        h_z = _encoder_trunk_tail(vae, vae.encoder.pool(emb)) if use_trunk else vae.encoder(emb)
    # (B, M, E) pre-cross latents
    x = _decoder_trunk(vae, h_z) if use_trunk else vae.decoder.trunk(h_z)

    ca = vae.decoder.decoder_cross_attention
    head = vae.decoder_head
    n_head = ca.attn.n_head
    # the tail's operands in f32 whatever the compute dtype, as JAX builds them
    f32 = torch.float32
    q = vae.input_layer.gene_embedding.weight[1:].float()  # canonical genes 1..G
    qp = ca.attn.c_attn_q(ca.ln_1q(q), f32).contiguous()
    k, v = ca.attn.c_attn(ca.ln_1(x.float()), f32).chunk(2, dim=-1)
    kfull, vproj = build_attention_operands(k, v, ca.attn.c_proj.weight.t().float(), n_head)
    weights = pack_weights(
        ca.ln_2.weight, ca.ln_2.bias, ca.mlp.w1.weight.t(), ca.mlp.w2.weight.t(),
        ca.mlp.c_proj.weight.t(), head.params.weight.t(), head.params.bias,
    )
    eps = ca.ln_1.eps
    B = kfull.shape[0]
    if batch_chunk and B > batch_chunk:
        logits = torch.cat([
            decoder_tail(qp, q, kfull[lo : lo + batch_chunk], vproj[lo : lo + batch_chunk],
                         weights, n_head, eps)
            for lo in range(0, B, batch_chunk)
        ])
    else:
        logits = decoder_tail(qp, q, kfull, vproj, weights, n_head, eps)  # (B, G) f32

    theta = torch.exp(head.theta.weight[1:, 0].float())  # (G,)
    mu = torch.softmax(logits / head.t, dim=1) * batch[LIB]
    return {"mu": mu, "theta": theta}, h_z


def _ln_affine(x: torch.Tensor, ln: LayerNormFP32, eps: float) -> torch.Tensor:
    """Affine LayerNorm written out (JAX `_ln_affine`), in x's dtype."""
    m = x.mean(dim=-1, keepdim=True)
    v = (x - m).square().mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * ln.weight + ln.bias


def _algebraic_path_ok(vae: TransformerVAE) -> bool:
    """The JAX gate of `algebraic_nb_apply`: `_nb_tail_ok` without the width
    limit, with E split evenly over the cross heads."""
    dec = vae.decoder
    return _nb_tail_ok(vae) and dec.n_embed % dec.decoder_cross_attention.attn.n_head == 0


def _algebraic_tail(
    vae: TransformerVAE,
    x: torch.Tensor,  # (B, M, E) pre-cross latents (the decoder trunk's output)
    library_size: torch.Tensor,  # (B, 1)
    fused_gate: bool = False,
    vw_fold: bool = False,
    gene_sp: Optional[GeneSP] = None,
) -> Dict[str, torch.Tensor]:
    """The decoder's cross block and NB head over the canonical gene list,
    reassociated (JAX `_algebraic_tail`): the SwiGLU down projection's only
    consumer is the head's mu vector, so `wv = c_proj @ wmu` replaces the
    (B, G, E) down projection. `vw_fold` contracts the probabilities against
    the values folded through the output projection, `probs @ (v @ wo)` with
    K = H*M, instead of `sdpa_shared_q` then `@ wo`. `fused_gate` runs the
    up projection, the gate and the wv contraction as `swiglu_vec` over
    `w12 = [w1 | w2]`; otherwise two separate products (not `hn @ w12`).
    Differentiable in every parameter. The casts to the decoder's compute
    dtype sit where JAX's do (identities in f32), and the contractions JAX
    sums in f32 (`preferred_element_type`) take f32 copies of their bf16
    operands. With `gene_sp` the tail runs over this "model" rank's genes,
    the NB mean's softmax across every rank's (JAX's gene-SP constraint on
    the query table). Under Megatron (the layers' `tp`) each rank contracts
    its heads and its hidden slice (`swiglu_vec` over its Hd columns of
    `w12` and rows of `wv`), the partial `y` and mlp term all-reduced."""
    ca = vae.decoder.decoder_cross_attention
    head = vae.decoder_head
    eps = ca.ln_1.eps
    attn, mlp = ca.attn, ca.mlp
    dt = vae.decoder.dtype
    E = vae.decoder.n_embed
    hd = E // attn.n_head
    # under Megatron: this rank's heads and hidden slice (`attn.tp`, `mlp.tp`)
    at, mt = attn.tp, mlp.tp
    heads = attn.n_head if at is None else attn.n_head // at.size

    q32 = table(vae.input_layer.gene_embedding)[1:].float()  # canonical genes 1..G
    if gene_sp is not None:
        q32 = gene_sp.take(q32, 0)
    qn = _ln_affine(q32, ca.ln_1q, eps).to(dt)
    xn = _ln_affine(x.float(), ca.ln_1, eps).to(dt)
    if at is None:
        qp = qn @ weights(attn.c_attn_q)[0].t().to(dt)  # (G, heads * hd)
        kv = xn @ weights(attn.c_attn)[0].t().to(dt)  # (B, M, 2 * heads * hd)
    else:
        qp = column(column_input(qn, at, dt), attn.c_attn_q, dt)
        kv = column(column_input(xn, at, dt), attn.c_attn, dt)
    k, v = kv.chunk(2, dim=-1)
    B, M = k.shape[0], k.shape[1]
    G = qp.shape[0]
    wo = weights(attn.c_proj)[0].t().to(dt)  # (heads * hd, E), (in, out)
    if vw_fold:
        # y @ wo = sum_h probs_h @ (v_h @ wo_h): one product with K = H*M
        scores = torch.einsum("mhd,bshd->bhms", qp.reshape(G, heads, hd).float(),
                              k.reshape(B, M, heads, hd).float())
        probs = torch.softmax(scores * (1.0 / math.sqrt(hd)), dim=-1).to(dt)
        vw = torch.einsum("bshd,hde->bhse", v.reshape(B, M, heads, hd),
                          wo.reshape(heads, hd, E))  # (B, H, M, E)
        if at is None:
            y = torch.einsum("bhms,bhse->bme", probs, vw)  # (B, G, E)
        else:  # the heads' partial sums in f32, rounded to dt once summed
            y = at.reduce_from(torch.einsum("bhms,bhse->bme", probs.float(), vw.float())).to(dt)
    else:
        y = sdpa_shared_q(qp.reshape(G, heads, hd), k.reshape(B, M, heads, hd),
                          v.reshape(B, M, heads, hd)).reshape(B, G, heads * hd)
        y = y @ wo if at is None else at.reduce_from(y.float() @ wo.float()).to(dt)

    h = q32.to(dt)[None] + y  # the residual connects to the raw queries
    hn = _ln_affine(h.float(), ca.ln_2, eps).to(dt)
    wmu = head.params.weight.t()  # (E, 1)
    # the fusion, wv (Hd, 1); under Megatron of this rank's Hd rows, so the
    # replicated wmu enters it as a column-parallel operand
    wv = (mlp.c_proj.weight.t() @ (wmu if mt is None else mt.copy_to(wmu))).to(dt)
    if fused_gate:
        w12 = torch.cat([mlp.w1.weight.t(), mlp.w2.weight.t()], dim=1).to(dt)
        x12 = hn if mt is None else mt.copy_to(hn)  # the kernels' dx is in hn's dtype
        mlp_term = swiglu_vec(x12.reshape(-1, E), w12, wv).reshape(B, G)
    else:
        # two separate products, not hn @ w12: no (B, G, 2Hd) up projection
        if mt is None:
            a = hn @ mlp.w1.weight.t().to(dt)  # (B, G, Hd)
            b = hn @ mlp.w2.weight.t().to(dt)
        else:
            hc = column_input(hn, mt, dt)
            a, b = column(hc, mlp.w1, dt), column(hc, mlp.w2, dt)
        g3 = silu(a) * b  # the largest live tensor
        mlp_term = torch.einsum("bgh,h->bg", g3.float(), wv[:, 0].float())
    if mt is not None:  # the hidden slices' partial sums
        mlp_term = mt.reduce_from(mlp_term)
    logits = (
        torch.einsum("bge,e->bg", h.float(), wmu[:, 0].to(dt).float())
        + mlp_term
        + head.params.bias[0].float()
    )
    theta = torch.exp(head.theta.weight[1:, 0].float())
    if gene_sp is not None:
        return {"mu": gene_sp.softmax(logits / head.t) * library_size,
                "theta": gene_sp.take(theta, 0)}
    mu = torch.softmax(logits / head.t, dim=1) * library_size
    return {"mu": mu, "theta": theta}


def algebraic_nb_apply(
    vae: TransformerVAE, batch: Dict, fused_gate: bool = False, vw_fold: bool = False,
    gene_sp: Optional[GeneSP] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """`TransformerVAE.forward` with the decoder's cross block and NB head
    reassociated (`_algebraic_tail`), over the canonical gene list 1..G, from
    a materialised lean batch. The encoder runs as modules (the dense pool is
    gated to E <= 128), then `decoder.trunk`, then the tail. Returns
    ({"mu", "theta"}, h_z)."""
    h_z = vae.encoder(vae.input_layer(batch[C_SUB], batch[G_SUB]))
    x = vae.decoder.trunk(h_z)  # (B, M, E) pre-cross latents
    return _algebraic_tail(vae, x, batch[LIB], fused_gate=fused_gate, vw_fold=vw_fold,
                           gene_sp=gene_sp), h_z


def algebraic_decode(
    vae: TransformerVAE,
    z: torch.Tensor,  # (B, M, E_latent) latents (generation samples)
    library_size: torch.Tensor,  # (B, 1)
    fused_gate: bool = False,
    vw_fold: bool = False,
    gene_sp: Optional[GeneSP] = None,
) -> Dict[str, torch.Tensor]:
    """`TransformerVAE.decode` over the canonical gene list 1..G with the
    cross block and NB head reassociated (`_algebraic_tail`): the decoder
    trunk, then the tail. The generation decode at E > 128 (JAX
    `algebraic_decode`); with `gene_sp`, of this rank's genes."""
    return _algebraic_tail(vae, vae.decoder.trunk(z), library_size, fused_gate=fused_gate,
                           vw_fold=vw_fold, gene_sp=gene_sp)


def gene_sp_decode(vae: TransformerVAE, z: torch.Tensor, genes: torch.Tensor,
                   library_size: torch.Tensor, sp: GeneSP) -> Dict[str, torch.Tensor]:
    """`TransformerVAE.decode` of this "model" rank's genes of `genes` ((G,)
    or (B, G)): the decoder's queries of those genes, then the head, whose
    NB softmax spans every rank's genes (`GeneSP.softmax`)."""
    genes = sp.take(genes, -1)
    return vae._head_params(vae.decoder(z, vae._decoder_queries(genes)), genes, library_size,
                            softmax=sp.softmax)


def gene_sp_loss(counts: torch.Tensor, out: Dict[str, torch.Tensor], gaussian_head: bool,
                 sp: GeneSP) -> torch.Tensor:
    """`vae_loss` of the whole gene axis from this rank's part of the head's
    parameters: each rank's gene sum, summed across the ranks
    (`GeneSP.sum`). `counts` are the whole (B, G) counts."""
    if gaussian_head:
        recon = log_gaussian(sp.take(log1p_cpm(counts), -1), out["mu"])
    else:
        recon = -log_nb_positive(sp.take(counts, -1), out["mu"], out["theta"])
    return sp.sum(recon.sum(dim=1).mean())


def vae_loss(counts: torch.Tensor, params: Dict[str, torch.Tensor],
             gaussian_head: bool = False) -> torch.Tensor:
    """Reconstruction loss, summed over genes, averaged over the batch: the
    NB negative log-likelihood, or under the Gaussian head the squared error
    of its mean against log1p-CPM of the counts."""
    if gaussian_head:
        recon = log_gaussian(log1p_cpm(counts), params["mu"])
    else:
        recon = -log_nb_positive(counts, params["mu"], params["theta"])
    return recon.sum(dim=1).mean()


def vae_loss_lean(
    genes_subset: torch.Tensor,  # (B, S) gene-token ids, 0 = <MASK> padding
    counts_subset: torch.Tensor,  # (B, S)
    params: Dict[str, torch.Tensor],  # mu (B, G), theta (G,) or (B, G)
    eps: float = 1e-8,
) -> torch.Tensor:
    """The NB reconstruction loss without the dense (B, G) counts (JAX
    `vae_loss_lean`). At a zero count the Gamma terms of the NB log-pmf
    cancel, so the gene sum splits into the zero-count term over every gene
    and a correction at the expressed (gene, count) pairs:

        -sum_g log_nb(c_g) = -sum_g log_nb(0 | mu_g)
                             -sum_{c_g>0} [log_nb(c_g) - log_nb(0 | mu_g)]

    the same terms as `vae_loss`, with `log_nb_positive`'s eps placement.
    Padding ids (0) gather column 0 and are masked out. The gather's
    backward is a scatter-add into mu's gradient: the expressed genes of a
    cell are distinct, so each entry takes at most one term and padding adds
    zeros."""
    mu = params["mu"].float()
    theta = params["theta"].float()
    zero_term = theta * (torch.log(theta + eps) - torch.log(theta + mu + eps))
    base = -zero_term.sum(dim=1)  # (B,)
    g_ids = genes_subset.long()
    cols = torch.clamp(g_ids - 1, 0, mu.shape[1] - 1)
    mu_s = torch.gather(mu, 1, cols)  # (B, S)
    theta_s = theta[cols] if theta.ndim == 1 else torch.gather(theta, 1, cols)
    c = counts_subset.float()
    corr = log_nb_positive(c, mu_s, theta_s, eps) - theta_s * (
        torch.log(theta_s + eps) - torch.log(theta_s + mu_s + eps)
    )
    corr = torch.where(g_ids > 0, corr, torch.zeros_like(corr))
    return (base - corr.sum(dim=1)).mean()


def validation_metrics(
    counts: torch.Tensor, out: Dict[str, torch.Tensor], counts_pred: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """The reference's validation metrics from the true counts, the head's
    parameters and the prediction: under the NB head, counts drawn from it,
    log1p-CPM scaled for the MSE and PCC; under the Gaussian head (no
    theta), its mean, already on that scale."""
    gaussian = "theta" not in out
    loss = vae_loss(counts, out, gaussian)
    mets = {"val_loss": loss, "val_llh": loss}
    if not gaussian:
        mets["val_theta"] = out["theta"].mean()
    pred_scaled = counts_pred if gaussian else log1p_cpm(counts_pred)
    true_scaled = log1p_cpm(counts)
    mets["val_zeros_accuracy"] = M.zeros_accuracy(counts_pred, counts)
    mets["val_mse"] = M.mse(pred_scaled, true_scaled)
    mets["val_pcc"] = M.nanmean(M.pearson_corrcoef(pred_scaled, true_scaled))
    return mets


class VAETask:
    """Owns the model's optimizer settings and the steps; the state carries
    the parameters (in the module), the optimizer state and the step.

    `fused_decoder=None` takes the kernel path wherever the batch is a lean
    batch of CUDA tensors and the architecture qualifies (`_fused_path_ok`);
    True takes it on any device where the architecture qualifies (on CPU
    tensors through the plain version of the kernels), False never. `fused_batch_chunk` splits the tail into
    launches over batch slices of that size; the CUDA kernels have no batch
    ceiling, so nothing splits them unless asked. `fused_pool=True` (off
    unless asked, as in JAX) pools the encoder's packed window through the
    window pool kernels on the module path (`_apply`: with
    `fused_decoder=False`, a dense batch, or in `eval_step`).

    `algebraic_tail=None` takes the algebraic tail (`algebraic_nb_apply`) on
    lean batches at E > 128 where the architecture qualifies
    (`_algebraic_path_ok`), as JAX does; `algebraic_vw_fold=None` folds the
    output projection into the values wherever that tail runs;
    `algebraic_fused_gate=True` (off unless asked, as in JAX) runs its
    SwiGLU through the `swiglu_vec` kernels.

    `fused_trunk=True` (off unless asked, as in JAX) runs both trunks of the
    kernel path (`_use_fused`) as the whole-trunk kernels where JAX's gate
    holds (`_fused_trunk_ok`); `eval_step` and `encode` keep the modules, as
    in JAX.

    `lean_loss=True` (off unless asked, as in JAX) takes the NB loss
    without densifying the counts (`vae_loss_lean`) where `_use_lean_loss`
    holds: a lean batch on the kernel path or the algebraic tail under the
    NB head.

    A VAE with dropout closes every kernel gate, as in JAX: its training
    steps take the module path, with the dropout draws seeded from the
    state's generator (`layers.Drops.draw`); evaluation does not drop. Under
    the Gaussian head (`gaussian_head`) the loss is the squared error of its
    mean against log1p-CPM and there is no theta metric.

    `mesh` (`parallel.make_mesh`; one process per card, so a rank is a JAX
    process) trains data-parallel over its "data" axis: each rank steps on
    its own rows, the initial weights come from rank 0, and the gradients
    are averaged over "data" before the clip and the metrics come back as
    the global means (`parallel.data_parallel.Layout`). JAX closes every
    Pallas gate under a multi-device mesh (GSPMD cannot partition a
    `pallas_call`); under the port's data parallelism each rank runs a
    one-card step, so the kernel gates stay as on one card: the dispatch
    differs from JAX's, the math does not. `fsdp` keeps 1/n of every
    parameter JAX's rule shards, and of its AdamW moments, on each of n data
    ranks (`FlatShards`), and its step runs on the gathered full weights, so
    the kernel gates stay open there too; `gene_sp` with a "model" axis
    above 1 decodes a contiguous range of the genes on each model rank
    (`parallel.gene_sp`; the algebraic tail composes with it, and an
    unshared decoder raises JAX's ValueError). Under gene-SP the kernel
    gates close, as JAX's do: the tail kernels take the NB softmax over
    the whole gene axis, which there spans the ranks. A "model" axis above
    1 without gene-SP is JAX's Megatron layout (`parallel.sharding_rules`):
    each model rank keeps its slices of the column- and row-parallel
    weights and the embeddings' features, and their AdamW moments, and the
    steps run on the module path or the algebraic tail, whose
    `algebraic_fused_gate` runs `swiglu_vec` on each rank's hidden slice;
    the whole-module kernels (the decoder tail, the pools, the trunk) close,
    as JAX's do, since no rank holds their weights. At a model axis of 1
    `gene_sp` is ignored, as in JAX."""

    def __init__(
        self,
        vae: TransformerVAE,
        *,
        learning_rate: float = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.95),
        weight_decay: float = 0.0,
        caution: bool = False,
        grad_clip: float = 10.0,
        num_training_steps: int = 10_000,
        num_warmup_steps: Optional[int] = None,
        final_lr_factor: float = 0.1,
        init_div_factor: float = 100,
        fract_decay: float = 0.1,
        decay_type: str = "sqrt",
        calculate_grad_norms: bool = False,
        fused_decoder: Optional[bool] = None,
        fused_batch_chunk: Optional[int] = None,
        fused_pool: Optional[bool] = None,
        algebraic_tail: Optional[bool] = None,
        algebraic_vw_fold: Optional[bool] = None,
        algebraic_fused_gate: bool = False,
        fused_trunk: Optional[bool] = None,
        lean_loss: bool = False,
        mesh=None,
        fsdp: bool = False,
        gene_sp: bool = False,
    ):
        self.vae = vae
        self.gaussian_head = isinstance(vae.decoder_head, GaussianTransformerHead)
        self.lean_loss = bool(lean_loss)
        n_model = 1 if mesh is None else axis_size(mesh, "model")
        self.gene_sp = bool(gene_sp) and n_model > 1
        self.megatron = n_model > 1 and not self.gene_sp
        self.layout = None if mesh is None else Layout(mesh, fsdp=fsdp, megatron=self.megatron)
        if self.gene_sp and not vae.decoder.shared_embedding:
            raise ValueError(
                "gene_sp requires the shared-embedding decoder (the default): unshared queries "
                "cannot be sharding-constrained on the gene axis before the cross block")
        self._sp = GeneSP(self.layout.model_group, vae.decoder.n_genes) if self.gene_sp else None
        # JAX's gates close under a multi-device mesh; the port's ranks run
        # one-card steps (under FSDP on the gathered weights), so only
        # gene-SP, whose NB softmax spans the ranks, and Megatron, where no
        # rank holds the whole-module kernels' weights, close them
        closed = self.gene_sp or self.megatron
        self.fused_trunk = bool(fused_trunk) and _fused_trunk_ok(vae) and not closed
        self.fused_pool = bool(fused_pool) and _fused_window_ok(vae) and not closed
        if algebraic_tail is None:
            algebraic_tail = vae.decoder.n_embed > 128
        self.algebraic_tail = bool(algebraic_tail) and _algebraic_path_ok(vae)
        self.algebraic_fused_gate = (bool(algebraic_fused_gate) and self.algebraic_tail
                                     and not self.gene_sp)
        if algebraic_vw_fold is None:
            algebraic_vw_fold = self.algebraic_tail
        self.algebraic_vw_fold = bool(algebraic_vw_fold) and self.algebraic_tail
        self.calculate_grad_norms = calculate_grad_norms
        self.fused_decoder = False if closed else (
            fused_decoder if fused_decoder is None else bool(fused_decoder))
        self.fused_batch_chunk = fused_batch_chunk
        if num_warmup_steps is None:
            num_warmup_steps = max(1, int(0.1 * num_training_steps))
        self.schedule = wsd_schedule(
            num_training_steps=num_training_steps,
            final_lr_factor=final_lr_factor,
            num_warmup_steps=num_warmup_steps,
            init_div_factor=init_div_factor,
            fract_decay=fract_decay,
            decay_type=decay_type,
        )
        self.grad_clip = grad_clip
        self._opt_kwargs = dict(learning_rate=learning_rate, schedule=self.schedule, betas=betas,
                                weight_decay=weight_decay, caution=caution)

    # -- state -----------------------------------------------------------------
    def init_state(self, generator: torch.Generator) -> TrainState:
        """A fresh optimizer state over `self.vae`, whose module keeps the
        weights it holds (draw them with `utils.weights.init_reference_`, or
        load them); `generator` is the state's source of random draws. On a
        mesh every rank takes rank 0's weights and the model ranks of a data
        row its first one's generator state; under Megatron the module is
        cut to each model rank's slices; under FSDP the optimizer updates
        the slices and the module's sharded tensors are emptied."""
        params, shards = trained_params(self.layout, self.vae)
        state = create_train_state(self.vae, AdamWLegacy(params, **self._opt_kwargs), generator,
                                   shards=shards)
        if self.layout is not None:
            self.layout.mark_slices(state)
            self.layout.share_draws_(state)
        if shards is not None:
            shards.free()
        return state

    # -- dispatch --------------------------------------------------------------
    def _materialize(self, batch: Dict) -> Dict:
        """Widen the uint16 wire format; rebuild the dense counts and the
        canonical gene list when the batch carries only the expressed subsets."""
        batch = widen_lean(batch)
        if COUNTS in batch:
            return batch
        n_genes = self.vae.decoder.n_genes
        counts = densify_expressed(batch[G_SUB], batch[C_SUB], n_genes)
        out = dict(batch)
        out[COUNTS] = counts
        # 1-D genes: the decoder's batch-free query path
        out[GENES] = canonical_gene_ids(n_genes, device=counts.device)
        if LIB not in out:
            out[LIB] = counts.sum(1, keepdim=True)
        return out

    def _apply(self, batch: Dict, drops: Optional[Drops] = None
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The module path: `TransformerVAE.forward` (with the dropout draws
        `drops` where given), its MCAB pooling the window pool with
        `fused_pool` (whose gate excludes dropout); under gene-SP over this
        rank's genes (`_apply_gene_sp`)."""
        if self.gene_sp:
            return self._apply_gene_sp(batch, drops)
        if self.fused_pool:
            return self._apply_fused_pool(batch)
        return self.vae(
            counts=batch[COUNTS],
            genes=batch[GENES],
            library_size=batch[LIB],
            counts_subset=batch.get(C_SUB, batch[COUNTS]),
            genes_subset=batch.get(G_SUB, batch[GENES]),
            drops=drops,
        )

    def _apply_fused_pool(self, batch: Dict) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """`TransformerVAE.forward` with the MCAB pooling as the window pool
        (JAX `_apply_fused_pool`); the trunks, the decoder and the head stay
        modules."""
        vae = self.vae
        emb = vae.input_layer(batch.get(C_SUB, batch[COUNTS]), batch.get(G_SUB, batch[GENES]))
        h_z = vae.encoder.trunk(fused_window_pooling(vae, emb))
        genes = batch[GENES]
        h_x = vae.decoder(h_z, vae._decoder_queries(genes))
        return vae._head_params(h_x, genes, batch[LIB]), h_z

    def _apply_gene_sp(self, batch: Dict, drops: Optional[Drops] = None
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """`TransformerVAE.forward` with the decoder's gene axis split over
        the "model" ranks (JAX `_apply_gene_sp`): the encoder on every rank,
        the decoder's cross block and head over this rank's genes."""
        vae = self.vae
        emb = vae.input_layer(batch.get(C_SUB, batch[COUNTS]), batch.get(G_SUB, batch[GENES]))
        h_z = vae.encoder(emb, drops)
        return gene_sp_decode(vae, h_z, batch[GENES], batch[LIB], self._sp), h_z

    def _use_fused(self, batch: Dict) -> bool:
        """The kernel path needs a lean batch (the canonical gene list) and an
        eligible architecture; with `fused_decoder=None`, CUDA tensors too."""
        if self.fused_decoder is False or COUNTS in batch or C_SUB not in batch:
            return False
        if not _fused_path_ok(self.vae):
            return False
        return self.fused_decoder is True or batch[C_SUB].is_cuda

    def _use_algebraic(self, batch: Dict) -> bool:
        """The algebraic tail needs a lean batch (the canonical gene list)."""
        return self.algebraic_tail and COUNTS not in batch and C_SUB in batch

    def _algebraic(self, batch: Dict) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        return algebraic_nb_apply(self.vae, batch, fused_gate=self.algebraic_fused_gate,
                                  vw_fold=self.algebraic_vw_fold,
                                  **({} if self._sp is None else {"gene_sp": self._sp}))

    def _use_lean_loss(self, batch: Dict, on_reassoc_path: bool) -> bool:
        """JAX's gate of the densify-free NB loss: opted in, on the kernel
        path or the algebraic tail, the NB head, no gene-SP, and a lean
        batch (no dense counts, the expressed subsets)."""
        return (self.lean_loss and on_reassoc_path and not self.gaussian_head
                and not self.gene_sp and COUNTS not in batch and C_SUB in batch)

    def _has_dropout(self) -> bool:
        return self.vae.encoder.dropout > 0 or self.vae.decoder.dropout > 0

    # -- steps -----------------------------------------------------------------
    def loss(self, batch: Dict, drops: Optional[Drops] = None) -> Tuple[torch.Tensor, Dict]:
        """Reconstruction loss of a batch on the module's current parameters
        (differentiable), and its aux metrics; a training forward's dropout
        draws are `drops` (without them the modules do not drop)."""
        use_fused = self._use_fused(batch)
        use_algebraic = not use_fused and self._use_algebraic(batch)
        use_lean = self._use_lean_loss(batch, use_fused or use_algebraic)
        # the lean loss reads the wire-format subsets: no dense counts are built
        batch = widen_lean(batch) if use_lean else self._materialize(batch)
        if use_fused:
            out, _ = fused_nb_apply(self.vae, batch, batch_chunk=self.fused_batch_chunk,
                                    use_trunk=self.fused_trunk)
        elif use_algebraic:
            out, _ = self._algebraic(batch)
        else:
            out, _ = self._apply(batch, drops)
        if use_lean:
            loss = vae_loss_lean(batch[G_SUB], batch[C_SUB], out)
        elif self.gene_sp:
            loss = gene_sp_loss(batch[COUNTS], out, self.gaussian_head, self._sp)
        else:
            loss = vae_loss(batch[COUNTS], out, self.gaussian_head)
        aux = {"llh": loss.detach()}
        if "theta" in out:
            theta = out["theta"].detach()
            if self.gene_sp:  # the mean over every rank's genes
                sums = self._sp.total(torch.stack([theta.sum(), theta.new_tensor(theta.numel())]))
                aux["theta"] = sums[0] / sums[1]
            else:
                aux["theta"] = theta.mean()
        return loss, aux

    def train_step(self, state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        """One optimizer step; updates `state` in place and returns it with the
        step's metrics (0-d tensors on the batch's device). A VAE with
        dropout draws the step's masks from the state's generator. Under
        FSDP the full weights are gathered for the forward and backward."""
        state.optimizer.zero_grad(set_to_none=True)
        if state.shards is not None:
            state.shards.gather()
        drops = Drops.draw(self.vae, state.generator) if self._has_dropout() else None
        loss, aux = self.loss(batch, drops)
        loss.backward()
        mets = {"train_loss": loss.detach(), "train_llh": aux["llh"]}
        if "theta" in aux:
            mets["train_theta"] = aux["theta"]
        return state, self.apply_gradients(state, mets)

    def apply_gradients(self, state: TrainState, metrics: Optional[Dict] = None) -> Dict:
        """The step after the backward: on a mesh the gradients' reduction
        (and `metrics`' means over "data"), the global-norm clip of the
        gradients and the optimizer step on the schedule. Updates `state` in
        place and returns `metrics` with grad_norm, lr_mult and, with
        `calculate_grad_norms`, the per-module norms."""
        metrics, named, norm = step_gradients(self.layout, state, metrics, self.gene_sp)
        grads = [g for _, g in named]
        # one global-norm pass shared by the clip and the metric
        gnorm = norm(grads)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0)
        torch._foreach_mul_(grads, scale)
        lr_mult = self.schedule(state.step)
        state.optimizer.step()
        state.step += 1
        metrics.update(grad_norm=gnorm.detach(), lr_mult=torch.tensor(lr_mult, device=gnorm.device))
        if self.calculate_grad_norms:
            metrics.update(M.grad_norms_by_module(named, norm=norm))
        return metrics

    def train_steps(self, state: TrainState, stacked: Dict) -> Tuple[TrainState, Dict]:
        """K steps, one per slice of the leading axis of `stacked`'s leaves
        ((K, batch, ...)); returns the metrics' means over the K steps."""
        k = next(iter(stacked.values())).shape[0]
        runs = []
        for i in range(k):
            state, mets = self.train_step(state, {key: v[i] for key, v in stacked.items()})
            runs.append(mets)
        return state, {key: torch.stack([m[key] for m in runs]).mean() for key in runs[0]}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict, generator: torch.Generator) -> Dict:
        """Validation metrics on the module path, or on the algebraic tail
        where JAX takes it; the NB draw comes from `generator` (on the batch's
        device). Under the Gaussian head the prediction is its mean. Under
        gene-SP the ranks' genes are gathered before the draw."""
        use_algebraic = self._use_algebraic(batch)
        batch = self._materialize(batch)
        with full_weights(self.layout, state):
            out, _ = self._algebraic(batch) if use_algebraic else self._apply(batch)
        if self.gene_sp:
            out = {k: self._sp.gather(v, -1) for k, v in out.items()}
        pred = out["mu"] if self.gaussian_head else nb_sample(out["mu"], out["theta"], generator)
        return validation_metrics(batch[COUNTS], out, pred)

    @torch.no_grad()
    def encode(self, batch: Dict, state: Optional[TrainState] = None) -> torch.Tensor:
        """Latents of a batch from the expressed subsets (or the full counts);
        under FSDP pass the train state, whose full weights are gathered."""
        batch = widen_lean(batch)
        counts = batch.get(C_SUB, batch.get(COUNTS))
        genes = batch.get(G_SUB, batch.get(GENES))
        if counts is None or genes is None:
            raise KeyError("encode needs counts/genes or counts_subset/genes_subset in the batch")
        with full_weights(self.layout, state):
            return self.vae.encode(counts, genes)
