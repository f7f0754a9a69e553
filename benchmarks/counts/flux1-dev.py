"""Operations and bytes of one FLUX generation, counted from the
configuration's shapes and chipmunk settings alone (never from what the
program selected or counted), so the count is the same whatever does the
work: computed steps count their work, skipped steps nothing; a sparse
attention step counts the key blocks the settings keep (top_keys rounded
to counts_multiple_of, at most jmax a query group), a sparse MLP step
the neuron blocks they keep on average (the top-k union a
random_keys-Bernoulli of the rest, at most jmax a token block).

``count(config, traffic)`` returns per generation: ``flops`` (the
transformer and the decoder), ``attn_bound_s`` (the least time of every
attention kernel launch, the larger of its operations at the bf16 peak
and its bytes at the HBM peak), ``mlp_bound_s`` (the same for the sparse
MLP kernel pair) and the launch counts behind them."""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from benchmarks.families.flux import merged  # noqa: E402
from benchmarks.reference.flux import (AttnRef, MlpRef,  # noqa: E402
                                       step_kinds)

PEAK_BF16_FLOPS = 989e12      # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def attn_kept(a: dict, S: int):
    """(key blocks a query group attends on a sparse step, whether the
    layer falls back to dense), by the reference's reading of the
    settings: top-k of the column sums, counts rounded up to
    counts_multiple_of and clamped to [1, jmax]."""
    r = AttnRef(a, S)
    return min(r.jmax, max(1, -(-r.sel // r.mult) * r.mult)), r.fully_dense


def mlp_kept(mc: dict, N: int) -> float:
    """Neurons a token block recomputes on a sparse step, on average: the
    top-k blocks union a random_keys-Bernoulli of the rest, at most
    jmax."""
    r = MlpRef(mc, 1, N)
    nb = N // r.bn
    return min(r.jmax, r.sel + r.rand * (nb - r.sel)) * r.bn


def decoder_flops(a: dict, h: int, w: int) -> float:
    """The autoencoder decoder's convolutions and bottleneck attention on
    a latent of h x w."""
    ch, mult, nres, z = a['ch'], a['ch_mult'], a['num_res_blocks'], \
        a['z_channels']

    def conv(cin, cout, k, hw):
        return 2.0 * cin * cout * k * k * hw

    def res(cin, cout, hw):
        f = conv(cin, cout, 3, hw) + conv(cout, cout, 3, hw)
        return f + (conv(cin, cout, 1, hw) if cin != cout else 0.0)

    hw = h * w
    cur = ch * mult[-1]
    f = conv(z, cur, 3, hw) + 2 * res(cur, cur, hw)
    f += 4 * conv(cur, cur, 1, hw) + 2 * 2.0 * hw * hw * cur
    for i in reversed(range(len(mult))):
        cout = ch * mult[i]
        for _ in range(nres + 1):
            f += res(cur, cout, hw)
            cur = cout
        if i > 0:
            hw *= 4
            f += conv(cur, cur, 3, hw)
    return f + conv(cur, 3, 3, hw)


def count(config: dict, traffic: dict) -> dict:
    m = config['model']
    ck = merged(config['chipmunk'], traffic.get('chipmunk', {}))
    B = traffic.get('batch', 1)
    C, H = m['hidden_size'], m['num_heads']
    D, N = C // H, int(C * m['mlp_ratio'])
    Ti, Tt = (config['height'] // 16) * (config['width'] // 16), m['txt_len']
    S = Ti + Tt
    a, mc = ck.get('attn', {}), ck.get('mlp', {})
    a_on, m_on = a.get('is_enabled', True), mc.get('is_enabled', True)
    kept, fully = attn_kept(a, S)
    qg, kb = a.get('mbm', 128), a.get('kv_block', 128)
    G, nb = S // qg, S // kb
    K = mlp_kept(mc, N)
    bm = mc.get('bm', 128)
    nd_a = a.get('first_n_dense_layers', 2)
    nd_m = mc.get('first_n_dense_layers', 2)
    n_layers = m['depth'] + m['depth_single_blocks']

    # attention calls (operations, bytes); every one runs attn_sm90_kernel
    qkvo = 4.0 * B * H * S * D * 2
    dense = (4.0 * B * H * S * S * D, qkvo + B * H * S * 4)
    colsum = (dense[0], dense[1] + B * H * G * nb * 4)
    blocks = min(nb, G * kept)
    csp = (4.0 * qg * kb * D * B * H * G * kept,
           2.0 * B * H * S * D * 2 + 2.0 * B * H * blocks * kb * D * 2
           + B * H * G * (kept + 1) * 4)

    def mlp_pair(T):
        """(operations, bound s) of a sparse MLP step's mm1 + mm2 on T
        tokens padded to bm."""
        Tp = -(-T // bm) * bm
        M = Tp // bm
        rows = N * (1.0 - (1.0 - K / N) ** M)    # weight rows read
        ops1 = ops2 = 2.0 * Tp * C * K
        b1 = Tp * C * 2 + rows * C * 2 + Tp * K * (1 + 1 + 2) + N * 2
        b2 = Tp * K * 2 + rows * C * 2 + Tp * C * (1 + 1)
        return ops1 + ops2, bound_s(ops1, b1) + bound_s(ops2, b2)

    flops = attn_bound = mlp_bound = 0.0
    launches = {'attention': 0, 'mlp_pair': 0}
    for s, kind in enumerate(step_kinds(ck, config['steps'])):
        if kind['skip']:
            continue
        f = 2.0 * B * (Ti * m['in_channels'] * C
                       + Tt * m['context_in_dim'] * C
                       + Ti * C * m['in_channels'])
        for li in range(n_layers):
            dbl = li < m['depth']
            # projections: qkv and out for both streams / the joint one
            f += 2.0 * B * S * C * 4 * C
            calls = []
            if not a_on or li < nd_a or fully or (kind['full_attn'] and
                                                   s == 0):
                calls = [dense]
            elif kind['full_attn']:
                calls = [colsum if kind['colsum'] else dense, csp]
            else:
                calls = [csp]
            for ops, nbytes in calls:
                f += ops
                attn_bound += bound_s(ops, nbytes)
                launches['attention'] += 1
            T = B * (Ti if dbl else S)
            if dbl:     # the text stream's MLP is always dense
                f += 4.0 * B * Tt * C * N
            if not m_on or li < nd_m or kind['full_mlp']:
                f += 4.0 * (-(-T // bm) * bm if m_on and li >= nd_m
                            else T) * C * N
            else:
                ops, bnd = mlp_pair(T)
                f += ops
                mlp_bound += bnd
                launches['mlp_pair'] += 1
                if kind['recompute']:
                    f += 2.0 * (-(-T // bm) * bm // mc.get('mbm', 128)) \
                        * C * N
        flops += f
    a_cfg = config['autoencoder']
    flops += B * decoder_flops(a_cfg, config['height'] // 8,
                               config['width'] // 8)
    return {'flops': flops, 'attn_bound_s': attn_bound,
            'mlp_bound_s': mlp_bound, 'launches': launches}


if __name__ == '__main__':
    import json
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = json.load(open(os.path.join(here, 'configs', 'flux1-dev.json')))
    for t in ('sparse.b1', 'dense.b1'):
        tr = json.load(open(os.path.join(here, 'traffic', f'{t}.json')))
        c = count(cfg, tr)
        print(t, json.dumps(c), f'{c["flops"] / 1e15:.3f} PFLOP')
