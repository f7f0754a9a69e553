"""The FLOP and byte counter against counts made by hand at small
shapes."""
import json
import os

import pytest

from benchmarks.core.loader import load_module

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
counts = load_module(os.path.join(BENCH_DIR, 'counts', 'flux1-dev.py'),
                     'bench_counts_test')


def small(chipmunk):
    """One double and one single block, C 256, 2 heads of 128, N 1024,
    128 text + 256 image tokens (S 384), 2 steps, a decoder of one
    level."""
    return {'model': {'in_channels': 64, 'vec_in_dim': 32,
                      'context_in_dim': 64, 'hidden_size': 256,
                      'num_heads': 2, 'mlp_ratio': 4.0, 'depth': 1,
                      'depth_single_blocks': 1, 'axes_dim': [16, 56, 56],
                      'theta': 10000, 'txt_len': 128},
            'autoencoder': {'ch': 32, 'ch_mult': [1], 'num_res_blocks': 0,
                            'z_channels': 16},
            'width': 256, 'height': 256, 'steps': 2, 'guidance': 4.0,
            'chipmunk': chipmunk}


DENSE = {'attn': {'is_enabled': False}, 'mlp': {'is_enabled': False},
         'step_caching': {'is_enabled': False}}


def test_dense_generation_by_hand():
    c = counts.count(small(DENSE), {'batch': 1})
    C, N, S, Ti, Tt, D, H = 256, 1024, 384, 256, 128, 128, 2
    emb = 2 * (Ti * 64 * C + Tt * 64 * C + Ti * C * 64)
    proj = 2 * S * C * 4 * C                      # qkv + out, per layer
    attn = 4 * H * S * S * D
    mlp_dbl = 4 * Ti * C * N + 4 * Tt * C * N     # image + text MLPs
    mlp_sgl = 4 * S * C * N
    step = emb + 2 * (proj + attn) + mlp_dbl + mlp_sgl
    # decoder: conv_in 16->32, two res 32->32, attention (4 1x1 convs and
    # two hw x hw products), one res 32->32 (ch_mult [1], 0 + 1 blocks),
    # conv_out 32->3, all on a 32 x 32 latent
    hw = 32 * 32
    conv3 = 2 * 32 * 32 * 9 * hw
    dec = (2 * 16 * 32 * 9 * hw + 3 * 2 * conv3 + 4 * 2 * 32 * 32 * hw
           + 2 * 2 * hw * hw * 32 + 2 * 32 * 3 * 9 * hw)
    assert c['flops'] == pytest.approx(2 * step + dec, rel=1e-12)
    assert c['launches'] == {'attention': 4, 'mlp_pair': 0}
    one = max(attn / 989e12, (4 * H * S * D * 2 + H * S * 4) / 3.35e12)
    assert c['attn_bound_s'] == pytest.approx(4 * one, rel=1e-12)
    assert c['mlp_bound_s'] == 0


def test_sparse_steps_count_the_kept_share():
    ck = {'attn': {'is_enabled': True, 'top_keys': 0.34,
                   'first_n_dense_layers': 0, 'full_step_every': 10,
                   'recompute_mask': False, 'should_compress_indices': False,
                   'dense_fallback_frac': 1.0},
          'mlp': {'is_enabled': True, 'top_keys': 0.25, 'random_keys': 0.0,
                  'first_n_dense_layers': 0, 'full_step_every': 10,
                  'neuron_block': 256, 'counts_multiple_of': 256, 'bm': 128},
          'step_caching': {'is_enabled': False}}
    cfg = small(ck)
    cfg['steps'] = 3               # first, colsum (step 1), sparse (step 2)
    c = counts.count(cfg, {'batch': 1})
    # attention: S 384 = 3 key blocks, top_keys 0.34 keeps 1 block a group
    assert counts.attn_kept(ck['attn'], 384) == (1, False)
    # MLP: 1024 neurons = 4 blocks of 256, top_keys 0.25 keeps 1
    assert counts.mlp_kept(ck['mlp'], 1024) == 256
    # launches: step 0 dense x2 layers; step 1 colsum + csp x2; step 2
    # csp x2; the MLP pair on steps 1 and 2 in both layers
    assert c['launches'] == {'attention': 2 + 4 + 2, 'mlp_pair': 4}
    csp_ops = 4 * 128 * 128 * 128 * 2 * 3 * 1
    dense_ops = 4 * 2 * 384 * 384 * 128
    C, Ti, S = 256, 256, 384
    mlp_pair_dbl = 2 * 2 * Ti * C * 256
    mlp_pair_sgl = 2 * 2 * S * C * 256
    full_mlp = 4 * Ti * C * 1024 + 4 * S * C * 1024
    txt_mlp = 4 * 128 * C * 1024
    sel = 2 * (Ti // 128) * C * 1024 + 2 * (S // 128) * C * 1024
    proj = 2 * 2 * S * C * 4 * C
    emb = 2 * (Ti * 64 * C + 128 * 64 * C + Ti * C * 64)
    dit = (3 * (emb + proj + txt_mlp) + 2 * dense_ops + full_mlp
           + 2 * (dense_ops + csp_ops) + 2 * csp_ops
           + 2 * (mlp_pair_dbl + mlp_pair_sgl + sel))
    dec = counts.decoder_flops(cfg['autoencoder'], 32, 32)
    assert c['flops'] == pytest.approx(dit + dec, rel=1e-12)


def test_random_keeps_add_their_expected_share():
    mc = {'top_keys': 0.3, 'random_keys': 0.05, 'neuron_block': 256,
          'counts_multiple_of': 256}
    # 48 blocks: 14 by top-k, 5% of the other 34 on average, jmax 22
    assert counts.mlp_kept(mc, 12288) == pytest.approx(
        (14 + 0.05 * 34) * 256)


def test_flux1_dev_launches_match_the_schedule():
    with open(os.path.join(BENCH_DIR, 'configs', 'flux1-dev.json')) as f:
        cfg = json.load(f)
    c = counts.count(cfg, {'batch': 1})
    # 25 computed steps: dense_attn 325 + dense_colsum_attn 55 + csp_attn
    # 1320 launches; the sparse MLP pair 1100
    assert c['launches'] == {'attention': 1700, 'mlp_pair': 1100}
    d = counts.count(cfg, {'batch': 1, 'chipmunk': {
        'attn': {'is_enabled': False}, 'mlp': {'is_enabled': False},
        'step_caching': {'is_enabled': False}}})
    assert d['launches'] == {'attention': 50 * 57, 'mlp_pair': 0}
