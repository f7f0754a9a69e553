"""Plain PyTorch reference of FLUX with chipmunk's sparse-delta
attention, sparse-delta MLP and step caching, in float32, one block at a
time.

Written from the published FLUX.1 transformer (double-stream MMDiT
blocks over [text, image], single-stream blocks, adaLN modulation,
3-axis RoPE, flow-matching Euler sampling with the resolution shift) and
from chipmunk's step rules (full, column-sum, plain-full and sparse
steps, periodic MLP re-selection, fp8 caches where the configuration
states them, skipped steps that reuse the last prediction).  It imports
nothing of the program.  Matmuls run in float32 with TF32 off
(``fp32_matmuls``).

A block is computed from given inputs and given chipmunk state (its
caches, sums and selections as they stood before the step), for the
query rows of one MLP token block: the keys and values of every row, the
attention, the MLP and the block's output for those rows only; the state
it writes comes back for comparison.  The modulation vector and the
rotary tables it works out itself from the step's time, the guidance
and the pooled text vector.

The weights come in the program's layout (linear ``w`` [d_in, d_out],
MLP ``w1t`` / ``w2`` [N, C]) in any float dtype and are read as float32
one leaf at a time.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch

LOG2E = math.log2(math.e)
FP8 = torch.float8_e4m3fn
FP8_OVERFLOW = 464.0      # 448 plus half an ulp: larger magnitudes are NaN
DEFAULT_SKIPS = (7, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26, 27, 29,
                 31, 33, 34, 35, 37, 38, 39, 41, 42, 43)


@contextlib.contextmanager
def fp32_matmuls():
    """Matmuls and convolutions in true float32 (TF32 off) inside."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to e4m3 to nearest even; |x| > 464 and infinities become NaN
    of x's sign (the rounding the configuration's fp8 caches state)."""
    xf = x.float()
    nan = torch.copysign(torch.full_like(xf, float('nan')), xf)
    return torch.where(xf.abs() > FP8_OVERFLOW, nan, xf).to(FP8)


def fp8_scaled(x: torch.Tensor, dims=None) -> torch.Tensor:
    """x through e4m3 with a scale of amax / 448 (over the whole tensor,
    or per slice along ``dims`` kept), back in float32: what an fp8
    operand keeps of x under current scaling."""
    xf = x.float()
    a = xf.abs().amax() if dims is None else xf.abs().amax(
        dim=tuple(d for d in range(xf.ndim) if d not in dims), keepdim=True)
    s = a.clamp(min=1e-30) / 448.0
    return (xf / s).to(FP8).float() * s


# ------------------------------------------------------------ the schedule

def step_kinds(ck: Dict, steps: int) -> List[Dict]:
    """Per step: full attention, column-sum step, full MLP, MLP
    re-selection, skipped."""
    attn, mlp, sc = ck.get('attn', {}), ck.get('mlp', {}), \
        ck.get('step_caching', {})
    sched = attn.get('full_step_schedule')
    every_a = attn.get('full_step_every', 10)
    every_m = mlp.get('full_step_every', 10)
    bmc = mlp.get('block_mask_cache', 2)
    skips = set(sc.get('skip_step_schedule', DEFAULT_SKIPS)) \
        if sc.get('is_enabled', True) else set()
    out = []
    for s in range(steps):
        fa = (s in set(sched)) if sched is not None else \
            (s < 2 or s % every_a == 0)
        fm = s % every_m == 0
        cs = fa and (s >= 1 if attn.get('recompute_mask', True) else s == 1)
        out.append(dict(full_attn=fa, colsum=cs, full_mlp=fm,
                        recompute=((s % bmc == 0) or s < 10) and not fm,
                        skip=(s in skips) and s > 0))
    return out


def timesteps(steps: int, image_seq_len: int, shift: bool = True
              ) -> List[float]:
    """Timesteps linear in sigma from 1 to 0 with FLUX's resolution shift,
    as float32 values."""
    t = torch.linspace(1, 0, steps + 1, dtype=torch.float32)
    if shift:
        m = (1.15 - 0.5) / (4096 - 256)
        mu = m * image_seq_len + 0.5 - m * 256
        t = math.exp(mu) / (math.exp(mu) + (1 / t - 1))
    return t.tolist()


def patch_order(h: int, w: int, c1: int, c2: int) -> np.ndarray:
    """Token permutation that makes c1 x c1 patches (of c2 x c2
    sub-patches) contiguous: ordered = flat[p]."""
    ids = np.arange(h * w).reshape(h // c1, c1, w // c1, c1)
    ids = ids.transpose(0, 2, 1, 3).reshape(-1, c1, c1)
    r = c1 // c2
    ids = ids.reshape(-1, r, c2, r, c2).transpose(0, 1, 3, 2, 4)
    return ids.reshape(-1)


# ----------------------------------------------------------- small pieces

def gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def layernorm(x, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def rmsnorm(x, scale, eps=1e-6):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def tembed(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    a = (t.float() * 1000.0)[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], -1)


def rope(ids: torch.Tensor, axes_dim, theta: float):
    """ids [B, S, n] -> (cos, sin) [B, 1, S, D/2]."""
    parts = []
    for i, d in enumerate(axes_dim):
        om = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=ids.device) / d)
        parts.append(ids[..., i].float()[..., None] * om)
    a = torch.cat(parts, -1)
    return torch.cos(a)[:, None], torch.sin(a)[:, None]


def apply_rope(x, cos, sin):
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       -1).reshape(x.shape)


def compact(mask: torch.Tensor, multiple: int, jmax: int):
    """(ids [..., jmax], counts [...]) of a block mask: the selected blocks
    in ascending order, then the others in ascending order, counts rounded
    up to ``multiple``, capped at the blocks there are and clamped to
    [1, jmax].  What the selection state holds."""
    n = mask.shape[-1]
    iota = torch.arange(n, device=mask.device)
    key = torch.where(mask, iota, iota + n)
    ids = torch.sort(key, -1).values[..., :min(jmax, n)] % n
    counts = (mask.sum(-1) + multiple - 1) // multiple * multiple
    return ids, counts.clamp(max=n).clamp(1, jmax)


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    m = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    if k > 0:
        m.scatter_(-1, torch.topk(scores, k, -1).indices, True)
    return m


class Selections:
    """The selections a reference run takes and how good each is.

    ``given`` maps (step, 'attn' | 'mlp', layer) to block ids and counts
    that the run takes in place of its own choice (the program's: a
    reference that follows the program from its state takes its
    selections too, so that the two compute the same sparse sums).  At
    every selection the run records its own choice (``mine``) and, for a
    given one, its regret under the run's own scores (``regret``)."""

    def __init__(self, given=None):
        self.given = given or {}
        self.mine: Dict = {}
        self.regret: List[float] = []

    def choose(self, key, scores, k, own):
        self.mine[key] = own
        if key in self.given:
            self.regret.append(regret(*self.given[key], scores, k))
        return self.given.get(key, own)


def regret(ids, counts, scores, k) -> float:
    """How much of the score of the k best blocks a selection misses: per
    row 1 - (its k best blocks' scores) / (the k best scores), the worst
    row.  0 for any selection that holds a row's top k; near 0 where it
    swaps blocks of nearly equal score."""
    n = scores.shape[-1]
    if k <= 0:
        return 0.0
    slot = torch.arange(ids.shape[-1], device=ids.device)
    chosen = torch.zeros(scores.shape[:-1] + (n + 1,), dtype=torch.bool,
                         device=scores.device)
    chosen.scatter_(-1, torch.where(slot < counts[..., None], ids.long(),
                                    n), True)
    s = scores.float()
    best = torch.topk(s, k, -1).values.sum(-1)
    got = torch.topk(s.masked_fill(~chosen[..., :n], 0.0), k,
                     -1).values.sum(-1)
    return float((1.0 - got / best.clamp(min=1e-30)).max())


# -------------------------------------------------------------- attention

def _heads(q, k):
    """Chunks of heads that keep a [Sq, Sk] float32 score block per head
    under about 2 GiB."""
    return max(1, int(2 ** 31 // (q.shape[-2] * k.shape[-2] * 4 * 3)))


def dense_attention(q, k, v, prev_lse=None, qg=128, kb=128):
    """o, lse (log2 domain) and, given ``prev_lse``, the block column sums
    [B, H, Sq/qg, Sk/kb] of 2^(s - prev_lse); q may hold any rows."""
    B, H, Sq, D = q.shape
    Sk = k.shape[-2]
    tau = LOG2E / math.sqrt(D)
    os_, lses, css = [], [], []
    step = _heads(q, k)
    for h0 in range(0, H, step):
        sl = slice(h0, h0 + step)
        s2 = torch.matmul(q[:, sl], k[:, sl].transpose(-1, -2)) * tau
        m = s2.amax(-1, keepdim=True)
        p = torch.exp2(s2 - m)
        l = p.sum(-1, keepdim=True)
        os_.append(torch.matmul(p / l, v[:, sl]))
        lses.append((m + torch.log2(l))[..., 0])
        if prev_lse is not None:
            pp = torch.exp2(s2 - prev_lse[:, sl, :, None])
            hh = pp.shape[1]
            css.append(pp.reshape(B, hh, Sq // qg, qg, Sk // kb, kb)
                       .sum((3, 5)))
        del s2, p
    o, lse = torch.cat(os_, 1), torch.cat(lses, 1)
    return o, lse, (torch.cat(css, 1) if css else None)


def block_sparse_attention(q, k, v, ids, counts, qg=128, kb=128):
    """Query group g attends to the key blocks ids[..., g, :counts] only,
    with the softmax over them."""
    B, H, S, D = q.shape
    G, J = ids.shape[-2], ids.shape[-1]
    tau = LOG2E / math.sqrt(D)
    tok = (ids.long()[..., None] * kb + torch.arange(kb, device=q.device)
           ).reshape(B, H, G, J * kb)
    ok = (torch.arange(J, device=q.device) < counts[..., None]
          ).repeat_interleave(kb, -1)                      # [B, H, G, J*kb]
    kk = torch.gather(k, 2, tok.reshape(B, H, -1, 1).expand(-1, -1, -1, D))
    vv = torch.gather(v, 2, tok.reshape(B, H, -1, 1).expand(-1, -1, -1, D))
    kk, vv = kk.reshape(B, H, G, J * kb, D), vv.reshape(B, H, G, J * kb, D)
    qq = q.reshape(B, H, G, qg, D)
    s2 = torch.matmul(qq, kk.transpose(-1, -2)) * tau     # [B,H,G,qg,J*kb]
    s2 = s2.masked_fill(~ok[..., None, :], float('-inf'))
    p = torch.softmax(s2 * math.log(2.0), -1)
    return torch.matmul(p, vv).reshape(B, H, S, D)


class AttnRef:
    """One sparse attention layer's chipmunk state and step rule, for
    the query rows it is given (whole query groups): ``cache``, ``lse``,
    ``ids`` and ``counts`` hold those rows' and groups' state."""

    def __init__(self, acfg: Dict, S: int, layer: int = 0,
                 sels: Optional[Selections] = None):
        self.layer, self.sels = layer, sels or Selections()
        self.enabled = acfg.get('is_enabled', True)
        if self.enabled and acfg.get('should_compress_indices', True):
            raise NotImplementedError('compressed indices (random keeps) '
                                      'are not in this reference')
        kb, cmo = acfg.get('kv_block', 128), acfg.get('counts_multiple_of',
                                                       128)
        self.qg, self.kb = acfg.get('mbm', 128), kb
        nb = S // kb
        self.sel = max(min(int(round(acfg.get('top_keys', 0.05) * S / cmo)
                               * cmo) // kb, nb), 0)
        self.mult = max(cmo // kb, 1)
        frac = acfg.get('max_selected_frac', 0.5)
        cap = nb if frac >= 1.0 else int(nb * frac)
        jmax = max(min(self.sel, cap, nb), 1)
        self.jmax = min(-(-jmax // self.mult) * self.mult, nb)
        fb = acfg.get('dense_fallback_frac', 0.45)
        self.fully_dense = fb < 1.0 and self.jmax >= nb * fb
        self.fp8_cache = acfg.get('out_cache_dtype') == 'float8_e4m3fn'
        self.lse = self.cache = self.ids = self.counts = None

    def stateful(self, dense_layer: bool) -> bool:
        return self.enabled and not dense_layer and not self.fully_dense

    def __call__(self, q, k, v, kind, step, dense_layer):
        if not self.stateful(dense_layer):
            return dense_attention(q, k, v)[0]
        if kind['full_attn']:
            if step == 0:
                o, self.lse, _ = dense_attention(q, k, v)
                return o
            if kind['colsum']:
                o, lse, cs = dense_attention(q, k, v, self.lse, self.qg,
                                             self.kb)
                own = compact(topk_mask(cs, self.sel), self.mult,
                              self.jmax)
                self.ids, self.counts = self.sels.choose(
                    (step, 'attn', self.layer), cs, self.sel, own)
            else:
                o, lse, _ = dense_attention(q, k, v)
            self.lse = lse
            d = o - block_sparse_attention(q, k, v, self.ids, self.counts,
                                           self.qg, self.kb)
            self.cache = to_fp8(d) if self.fp8_cache else d
            return o
        return self.cache.float() + block_sparse_attention(
            q, k, v, self.ids, self.counts, self.qg, self.kb)


# -------------------------------------------------------------------- MLP

def _raw(x: torch.Tensor) -> torch.Tensor:
    """fp8 values as their bytes (gather and scatter take no fp8)."""
    return x.view(torch.uint8) if x.dtype == FP8 else x


def _cooked(raw: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return raw.view(FP8) if like.dtype == FP8 else raw


class MlpRef:
    """One sparse MLP layer's chipmunk state and step rule (tokens padded
    to the token block ``bm``)."""

    def __init__(self, mcfg: Dict, T: int, N: int, layer: int = 0,
                 sels: Optional[Selections] = None):
        self.layer, self.sels = layer, sels or Selections()
        self.enabled = mcfg.get('is_enabled', True)
        self.bm, self.mbm = mcfg.get('bm', 128), mcfg.get('mbm', 128)
        self.bn = mcfg.get('neuron_block', 128)
        self.rand = mcfg.get('random_keys', 0.05)
        cmo = mcfg.get('counts_multiple_of', 256)
        self.T = -(-T // self.bm) * self.bm
        nb = N // self.bn
        self.sel = max(min(int(round(mcfg.get('top_keys', 0.3) * N / cmo)
                               * cmo) // self.bn, nb), 1)
        frac = mcfg.get('max_selected_frac', 0.5)
        cap = nb if frac >= 1.0 else int(nb * frac)
        margin = max(8, int(3 * self.rand * nb)) if self.rand > 0 else 0
        self.mult = max(cmo // self.bn, 1)
        jmax = max(min(self.sel + margin, cap, nb), 1)
        self.jmax = min(-(-jmax // self.mult) * self.mult, nb)
        self.act8 = mcfg.get('act_cache_dtype') == 'float8_e4m3fn'
        self.out8 = mcfg.get('out_cache_dtype') == 'float8_e4m3fn'
        self.out = self.act = self.bm_mid = self.ids = self.counts = None

    def stateful(self, dense_layer: bool) -> bool:
        return self.enabled and not dense_layer

    def _pad(self, x):
        return torch.nn.functional.pad(x, (0, 0, 0, self.T - x.shape[0]))

    def __call__(self, x, w1t, b1, w2, b2, kind, dense_layer, gen, mm):
        t = x.shape[0]
        if not self.enabled or dense_layer:
            return mm(gelu_tanh(mm(x, w1t.t()) + b1), w2) + b2
        x = self._pad(x)
        if kind['full_mlp']:
            mid = mm(x, w1t.t()) + b1
            pa = gelu_tanh(mid)
            out = mm(pa, w2) + b2
            self.out = to_fp8(out) if self.out8 else out
            self.act = to_fp8(pa) if self.act8 else pa
            self.bm_mid = mid.reshape(-1, self.mbm, mid.shape[-1]).mean(1)
            return out[:t]
        if kind['recompute']:
            self._select(x, w1t, b1, gen, mm, kind['step'])
        M, J, bn = self.ids.shape[0], self.ids.shape[1], self.bn
        rows = (self.ids.long()[..., None] * bn
                + torch.arange(bn, device=x.device)).reshape(M, J * bn)
        ok = (torch.arange(J, device=x.device) < self.counts[:, None]
              ).repeat_interleave(bn, -1)                    # [M, J*bn]
        xb = x.reshape(M, self.bm, -1)
        act = gelu_tanh(mm(xb, w1t[rows].transpose(1, 2))
                        + b1[rows][:, None, :])
        if self.act8:
            act = to_fp8(act)
        # gathers and scatters of fp8 values move their bytes
        cache = _raw(self.act).reshape(M, self.bm, -1)
        at = rows[:, None, :].expand(-1, self.bm, -1)
        old = torch.gather(cache, 2, at)
        delta = torch.where(ok[:, None, :],
                            act.float() - _cooked(old, self.act).float(),
                            torch.zeros((), device=x.device))
        out = self.out.float().reshape(M, self.bm, -1) + mm(delta, w2[rows])
        out = out.reshape(self.T, -1)
        self.out = to_fp8(out) if self.out8 else out
        keep = torch.where(ok[:, None, :], _raw(act), old)
        self.act = _cooked(cache.clone().scatter_(2, at, keep),
                           self.act).reshape(self.T, -1)
        return self.out[:t].float()

    def _select(self, x, w1t, b1, gen, mm, step):
        """Neuron blocks by the change of fc1 at the token-group means
        since the last refresh, top-k union a Bernoulli keep drawn from
        ``gen``; refresh the means at the blocks that survive jmax (all
        the blocks of a given selection, whose counts are exact when
        counts_multiple_of is one block)."""
        r = self.bm // self.mbm
        bmx = x.reshape(-1, self.mbm, x.shape[-1]).mean(1)
        bmfc1 = mm(bmx, w1t.t()) + b1                            # [Mb, N]
        Mb, N = bmfc1.shape
        d = (bmfc1 - self.bm_mid).abs().reshape(Mb // r, r, N).sum(1)
        scores = d.reshape(Mb // r, N // self.bn, self.bn).sum(-1)
        mask = topk_mask(scores, self.sel)
        if self.rand > 0:
            mask = mask | (torch.rand(mask.shape, generator=gen,
                                      device=mask.device) < self.rand)
        own = compact(mask, self.mult, self.jmax)
        self.ids, self.counts = self.sels.choose(
            (step, 'mlp', self.layer), scores, self.sel, own)
        M, nb = mask.shape
        slot = torch.arange(self.ids.shape[1], device=x.device)
        surv = torch.zeros((M, nb + 1), dtype=torch.bool, device=x.device)
        surv.scatter_(1, torch.where(slot < self.counts[:, None],
                                     self.ids.long(), nb), True)
        surv = surv[:, :nb]
        if self.ids is own[0]:
            surv = surv & mask
        elif self.mult != 1:
            raise ValueError('a given MLP selection needs counts_multiple_of '
                             'equal to neuron_block')
        surv = surv.repeat_interleave(self.bn, -1)
        self.bm_mid = torch.where(surv.repeat_interleave(r, 0), bmfc1,
                                  self.bm_mid)


# ------------------------------------------------------------------ model

class FluxRef:
    """FLUX with chipmunk in float32, block by block.  ``m``: the
    configuration's model sizes (hidden_size, num_heads, depth,
    depth_single_blocks, txt_len, axes_dim, theta, mlp_ratio,
    guidance_embed); ``ck``: its chipmunk settings as a plain dict;
    ``params``: the weights in the program's layout (blocks absent from
    it are never asked for); ``h_img`` x ``w_img``: the latent's tokens;
    ``fmt`` 'fp8': every matmul and the attention computed from e4m3
    operands (the control of the numbers that the program's own
    lower-precision path leaves alone)."""

    def __init__(self, m: Dict, ck: Dict, params: Dict, h_img: int,
                 w_img: int, fmt: Optional[str] = None):
        self.m, self.ck, self.p = m, ck, params
        self.h_img, self.w_img = h_img, w_img
        self.H = m['num_heads']
        self.nd_a = ck.get('attn', {}).get('first_n_dense_layers', 2)
        self.nd_m = ck.get('mlp', {}).get('first_n_dense_layers', 2)
        self.fp8 = fmt == 'fp8'

    def mm(self, a, b):
        """a @ b in float32; under fmt 'fp8' both operands first through
        e4m3 with a scale a tensor (current scaling)."""
        if self.fp8:
            return torch.matmul(fp8_scaled(a), fp8_scaled(b))
        return torch.matmul(a.float(), b.float())

    def qkv(self, q, k, v):
        """The attention's operands; under fmt 'fp8' each through e4m3
        with a scale a head (fp8 attention's descaling)."""
        if not self.fp8:
            return q, k, v
        return tuple(fp8_scaled(t, dims=(0, 1)) for t in (q, k, v))

    def lin(self, p, x):
        y = self.mm(x, p['w'])
        return y + p['b'].float() if 'b' in p else y

    def emb(self, p, x):
        return self.lin(p['out'], torch.nn.functional.silu(self.lin(p['in'],
                                                                    x)))

    def mod(self, p, vec, n):
        out = self.lin(p, torch.nn.functional.silu(vec))[:, None, :]
        parts = out.chunk(3 * n, -1)
        return [parts[3 * i:3 * i + 3] for i in range(n)]

    def split(self, z):
        B, S, C = z.shape
        return z.reshape(B, S, self.H, C // self.H).transpose(1, 2)

    @staticmethod
    def merge(o):
        return o.transpose(1, 2).reshape(o.shape[0], o.shape[2],
                                         o.shape[1] * o.shape[3])

    def perm(self, dev) -> torch.Tensor:
        """The program's token order of the latent (chipmunk's patches)."""
        pc = self.ck.get('patchify', {})
        if not pc.get('is_enabled', True):
            return torch.arange(self.h_img * self.w_img, device=dev)
        return torch.from_numpy(patch_order(
            self.h_img, self.w_img, pc.get('chunk_size_1', 8),
            pc.get('chunk_size_2', 4)).astype(np.int64)).to(dev)

    def vec(self, t: float, guidance: float, y: torch.Tensor
            ) -> torch.Tensor:
        """The modulation vector of a step at time ``t``."""
        B, dev = y.shape[0], y.device
        tt = torch.full((B,), t, dtype=torch.float32, device=dev)
        vec = self.emb(self.p['time_in'], tembed(tt))
        if self.m.get('guidance_embed', True):
            g = torch.full((B,), guidance, dtype=torch.float32, device=dev)
            vec = vec + self.emb(self.p['guidance_in'], tembed(g))
        return vec + self.emb(self.p['vector_in'], y.float())

    def pe(self, B: int, dev) -> tuple:
        """(cos, sin) [B, 1, S, D/2] of the joint sequence [text, image]
        in the program's token order."""
        nt = self.m['txt_len']
        rows = torch.arange(self.h_img, device=dev).repeat_interleave(
            self.w_img)
        cols = torch.arange(self.w_img, device=dev).repeat(self.h_img)
        ids = torch.cat([torch.zeros((nt, 3), dtype=torch.long, device=dev),
                         torch.stack([torch.zeros_like(rows), rows, cols],
                                     -1)[self.perm(dev)]], 0)
        return rope(ids[None].expand(B, -1, -1), self.m['axes_dim'],
                    self.m['theta'])

    def embed(self, img, txt):
        """The input projections of latent and text tokens."""
        return self.lin(self.p['img_in'], img), self.lin(self.p['txt_in'],
                                                         txt)

    def final(self, x_img, vec):
        """The final adaLN and projection of image tokens."""
        sh, sc = self.lin(self.p['final_mod'], torch.nn.functional.silu(vec)
                          )[:, None, :].chunk(2, -1)
        return self.lin(self.p['final_proj'],
                        (1 + sc) * layernorm(x_img.float()) + sh)

    def _mlp(self, st, x2d, w1t, b1, w2, b2, kind, dense, gen):
        return st(x2d, w1t.float(), b1.float(), w2.float(), b2, kind, dense,
                  gen, self.mm)

    def mlp(self, name: str, i: int, x2d, kind: Dict, st: 'MlpRef', gen):
        """Block ``i``'s image (double) or joint (single) MLP alone, on
        the rows ``x2d`` of its input."""
        q_ = self.p[name][i]
        if name == 'double':
            return self._mlp(st, x2d.float(), q_['img_w1t'], q_['img_b1'],
                             q_['img_w2'], q_['img_b2'].float(), kind,
                             i < self.nd_m, gen)
        return self._mlp(st, x2d.float(), q_['w1t'], q_['b1'], q_['w2'],
                         torch.zeros((), device=x2d.device), kind,
                         self.m['depth'] + i < self.nd_m, gen)

    def double(self, i: int, img, txt, vec, cos, sin, kind: Dict, rows,
               attn: 'AttnRef', mlp: 'MlpRef', gen,
               own: Optional['AttnRef'] = None):
        """Double block ``i`` from its inputs (img [B, S_img, C], txt [B,
        nt, C]) for the image rows ``rows`` (a slice, whole query groups)
        and every text row: (image rows out, text rows out).  ``attn``
        holds the state of the text rows then those image rows, ``mlp``
        that of their MLP token block; both are left as the step writes
        them.  ``own``: a second attention state, carried from step to
        step by this reference itself, whose output on the same operands
        is left in ``last_own`` (``last_attn``: that of ``attn``)."""
        q_, H, step = self.p['double'][i], self.H, kind['step']
        nt = txt.shape[1]
        img, txt = img.float(), txt.float()
        (s1, c1, g1), (s2, c2, g2) = self.mod(q_['img_mod'], vec, 2)
        (t1, d1, h1), (t2, d2, h2) = self.mod(q_['txt_mod'], vec, 2)
        iq, ik, iv = (self.split(z) for z in self.lin(
            q_['img_qkv'], (1 + c1) * layernorm(img) + s1).chunk(3, -1))
        tq, tk, tv = (self.split(z) for z in self.lin(
            q_['txt_qkv'], (1 + d1) * layernorm(txt) + t1).chunk(3, -1))
        iq = rmsnorm(iq[:, :, rows], q_['img_qnorm'].float())
        ik = rmsnorm(ik, q_['img_knorm'].float())
        tq, tk = rmsnorm(tq, q_['txt_qnorm'].float()), \
            rmsnorm(tk, q_['txt_knorm'].float())
        qrows = torch.cat([torch.arange(nt, device=img.device),
                           nt + torch.arange(img.shape[1],
                                             device=img.device)[rows]])
        qq = apply_rope(torch.cat([tq, iq], 2), cos[:, :, qrows],
                        sin[:, :, qrows])
        kk = apply_rope(torch.cat([tk, ik], 2), cos, sin)
        ops = self.qkv(qq, kk, torch.cat([tv, iv], 2))
        oh = attn(*ops, kind, step, i < self.nd_a)
        self.last_attn = oh
        self.last_own = None if own is None else \
            own(*ops, kind, step, i < self.nd_a)
        o = self.merge(oh)
        x = img[:, rows] + g1 * self.lin(q_['img_proj'], o[:, nt:])
        txt = txt + h1 * self.lin(q_['txt_proj'], o[:, :nt])
        x2 = (1 + c2) * layernorm(x) + s2
        mo = self._mlp(mlp, x2.reshape(-1, x2.shape[-1]), q_['img_w1t'],
                       q_['img_b1'], q_['img_w2'], q_['img_b2'].float(),
                       kind, i < self.nd_m, gen)
        x = x + g2 * mo.reshape(x.shape)
        tx2 = (1 + d2) * layernorm(txt) + t2
        txt = txt + h2 * (self.mm(gelu_tanh(
            self.mm(tx2, q_['txt_w1t'].t()) + q_['txt_b1'].float()),
            q_['txt_w2']) + q_['txt_b2'].float())
        return x, txt

    def single(self, i: int, x, vec, cos, sin, kind: Dict, rows,
               attn: 'AttnRef', mlp: 'MlpRef', gen,
               own: Optional['AttnRef'] = None):
        """Single block ``i`` from its input x [B, S, C] for the rows
        ``rows`` (a slice, whole query groups): those rows out; ``attn``
        and ``mlp`` as in ``double``."""
        q_, step = self.p['single'][i], kind['step']
        x = x.float()
        ((sh, sc, gate),) = self.mod(q_['mod'], vec, 1)
        xm = (1 + sc) * layernorm(x) + sh
        qq, kk, vv = (self.split(z) for z in self.lin(q_['qkv'], xm)
                      .chunk(3, -1))
        qq = apply_rope(rmsnorm(qq[:, :, rows], q_['qnorm'].float()),
                        cos[:, :, rows], sin[:, :, rows])
        kk = apply_rope(rmsnorm(kk, q_['knorm'].float()), cos, sin)
        n_d = self.m['depth']
        ops = self.qkv(qq, kk, vv)
        oh = attn(*ops, kind, step, n_d + i < self.nd_a)
        self.last_attn = oh
        self.last_own = None if own is None else \
            own(*ops, kind, step, n_d + i < self.nd_a)
        o = self.merge(oh)
        ao = self.lin(q_['o_proj'], o)
        xr = xm[:, rows]
        mo = self._mlp(mlp, xr.reshape(-1, xr.shape[-1]), q_['w1t'],
                       q_['b1'], q_['w2'], torch.zeros((), device=x.device),
                       kind, n_d + i < self.nd_m, gen)
        return x[:, rows] + gate * (ao + mo.reshape(ao.shape))


def unpack(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Latent tokens [B, (h w), (c 2 2)] -> [B, c, 2h, 2w]."""
    B, S, D = x.shape
    h, w, c = height // 16, width // 16, D // 4
    return x.reshape(B, h, w, c, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(
        B, c, 2 * h, 2 * w)
