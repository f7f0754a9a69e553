"""The port's multi-card sampling (chipmunk_torch/parallel and the sharded
models) over real multi-process gloo worlds on the CPU, held to the
reference's sharded functions on its 8-device CPU mesh.

A module fixture starts three worlds at once, one process a rank:
``sp4`` (sp=4), ``dp2sp2`` (dp=2 x sp=2) and ``sp2ring2`` (sp=2 x
ring=2).  Each worker runs every check of its world on inputs made from
a seed with numpy (the reference's weights carried over as numpy) and
saves what it got; meanwhile the test process runs the reference's
sharded functions on the same inputs.  The parametrised cases then
compare.  Random keeps are off on both sides (``random_keys: 0.0``), as
in every sharded test of the reference: torch cannot draw
jax.random's keeps.  A worker that fails exits at once, which ends its
world's collectives, so no case waits on a hung process.

Run as ``python tests/test_torch_parallel.py WORLD PORT RANK INPUTS OUT``
this file is one worker (it imports no JAX then).
"""
import os
import pickle
import socket
import subprocess
import sys
import traceback

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = {'sp4': {'sp': 4}, 'dp2sp2': {'dp': 2, 'sp': 2},
          'sp2ring2': {'sp': 2, 'ring': 2}}
WORKER_TIMEOUT = 600

# float32 on both sides; the tolerances of the reference's own tests
ATTN_TOL = dict(atol=1e-4, rtol=1e-4)
RING_TOL = dict(atol=2e-5, rtol=2e-5)
LOOP_TOL = dict(atol=1e-3, rtol=1e-3)

FWD_MODEL = dict(in_channels=16, vec_in_dim=32, context_in_dim=32,
                 hidden_size=256, num_heads=4, mlp_ratio=2.0, depth=1,
                 depth_single_blocks=1, axes_dim=(16, 24, 24),
                 guidance_embed=False, txt_len=128)
FWD_CK = {'attn': {'top_keys': 0.4, 'kv_block': 32,
                   'counts_multiple_of': 32, 'first_n_dense_layers': 0,
                   'should_compress_indices': False},
          'mlp': {'is_enabled': False}}
FWD_GRID = (16, 24)
# the same forward with the sparse MLP on (bm 128) over 128 + 256 tokens:
# 3 token groups over sp=2, shards of 128 and 256
UNEVEN_GRID = (16, 16)
UNEVEN_CK = {'attn': dict(FWD_CK['attn']),
             'mlp': {'top_keys': 0.5, 'neuron_block': 32,
                     'counts_multiple_of': 32, 'first_n_dense_layers': 0,
                     'random_keys': 0.0}}
FWD_STEPS = [(0, True, True, False, False), (1, True, False, True, True),
             (2, False, False, False, False)]
ULYSSES_ATTN = dict(top_keys=0.4, kv_block=32, counts_multiple_of=32,
                    random_keys=0.0, should_compress_indices=False)

SAMPLER_MODEL = dict(FWD_MODEL)
SAMPLER_GRID = (16, 16)
SAMPLER_CK = {
    'steps': 4,
    'attn': {'top_keys': 0.4, 'kv_block': 32, 'counts_multiple_of': 32,
             'first_n_dense_layers': 1, 'should_compress_indices': False,
             'random_keys': 0.0},
    'mlp': {'top_keys': 0.5, 'neuron_block': 32, 'counts_multiple_of': 32,
            'first_n_dense_layers': 1, 'random_keys': 0.0},
    'patchify': {'chunk_size_1': 4, 'chunk_size_2': 2},
    'step_caching': {'is_enabled': False}}
HY_MODEL = dict(latent_t=8, latent_h=8, latent_w=16, in_channels=4,
                patch_size=(1, 2, 2), hidden_size=256, num_heads=4,
                mlp_ratio=4.0, depth_double=1, depth_single=1,
                axes_dim=(16, 24, 24), theta=256, text_dim=64, txt_len=128,
                vec_in_dim=32, guidance_embed=False, voxel_shape=(4, 4, 8))
HY_CK = {'steps': 4,
         'attn': {'top_keys': 0.3, 'kv_block': 32, 'counts_multiple_of': 32,
                  'random_keys': 0.0, 'local_voxels': 1,
                  'first_n_dense_layers': 1, 'full_step_schedule': [0, 1, 3],
                  'should_compress_indices': True, 'recompute_mask': True},
         'mlp': {'is_enabled': False},
         'step_caching': {'is_enabled': False}}
# the same loop with the sparse MLP on in groups of 256, a batch of 2 over
# dp=2 x sp=2: 256 image + 128 text tokens have no whole-group split, so
# both MLP streams are routed, the joint one across the two dp ranks
HY_ROUTED_CK = dict(HY_CK, mlp={
    'is_enabled': True, 'top_keys': 0.5, 'neuron_block': 32,
    'counts_multiple_of': 32, 'first_n_dense_layers': 0,
    'full_step_every': 3, 'random_keys': 0.0, 'bm': 256, 'mbm': 256})
WAN_MODEL = dict(latent_t=4, latent_h=8, latent_w=16, in_channels=4,
                 patch_size=(1, 2, 2), dim=256, ffn_dim=512, num_heads=4,
                 num_layers=2, text_dim=64, txt_len=64, freq_dim=64,
                 axes_dim=(16, 24, 24), voxel_shape=(4, 4, 8))
# MLP token groups of 32 so that 128 tokens split over sp=4
WAN_CK = {'steps': 4, 'num_model_invocations_per_inference_step': 2,
          'attn': {'top_keys': 0.3, 'kv_block': 32, 'counts_multiple_of': 32,
                   'random_keys': 0.0, 'local_voxels': 1,
                   'first_n_dense_layers': 1,
                   'full_step_schedule': [0, 1, 3]},
          'mlp': {'is_enabled': True, 'top_keys': 0.5, 'neuron_block': 32,
                  'counts_multiple_of': 32, 'first_n_dense_layers': 1,
                  'full_step_every': 3, 'random_keys': 0.0, 'bm': 32,
                  'mbm': 32},
          'step_caching': {'is_enabled': False}}
# the same loop with groups of 128: the 128 tokens are one group for the
# 4 ranks, so the MLP rows move to the one rank that computes the group
WAN_ONE_GROUP_CK = dict(WAN_CK, mlp=dict(WAN_CK['mlp'], bm=128, mbm=128))
# geometries with no whole-group split over sp=4: the tokens split as
# evenly as they allow and the MLP rows move to a whole-group split of
# their own; name -> (model kwargs, grid, ck, batch)
BM256 = {'attn': FWD_CK['attn'], 'mlp': dict(UNEVEN_CK['mlp'], bm=256)}
NO_SPLIT = {
    # 384 tokens are 3 groups of 128 for 4 ranks
    'fewer_groups_than_ranks': (FWD_MODEL, (16, 16), UNEVEN_CK, 1),
    # 128 text tokens, bm 256: the image stream's groups start mid-group
    'image_groups_cut': (FWD_MODEL, (16, 48), BM256, 1),
    # 256 text + 640 image tokens, bm 256, a batch of 2 on every rank:
    # the second sequence's groups start mid-group
    'batch_fold_cut': (dict(FWD_MODEL, txt_len=256), (16, 40), BM256, 2),
}
# dp=2 x sp=2, a batch of 2 over dp, 128 text + 256 image tokens, bm 256:
# the joint sequence's second group crosses the two dp ranks' rows
DP_CROSS = (FWD_MODEL, (16, 16), BM256, 2)


def seeded_inputs():
    """Every numpy input of the checks, made from one seed."""
    rng = np.random.default_rng(0)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    fh, fw = FWD_GRID
    uh, uw = UNEVEN_GRID
    sh, sw = SAMPLER_GRID
    return {
        'collect_x': normal(1, 8, 64, 16),
        'ulysses_qkv': normal(3, 1, 8, 512, 32),
        'fwd': (normal(1, fh * fw, 16), normal(1, 128, 32), normal(1, 32)),
        'uneven': (normal(1, uh * uw, 16), normal(1, 128, 32),
                   normal(1, 32)),
        'ring_qkv': normal(3, 1, 4, 512, 64),
        'usp_qkv': normal(3, 1, 4, 512, 64),
        'sampler': (normal(2, sh * sw, 16), normal(2, 128, 32),
                    normal(2, 32)),
        'hunyuan': (normal(2, 4, 8, 8, 16), normal(2, 128, 64),
                    normal(2, 32)),
        'wan': (normal(1, 4, 4, 8, 16), normal(1, 64, 64),
                normal(1, 64, 64)),
        **{f'no_split/{name}': flux_inputs(normal, mkw, grid, batch)
           for name, (mkw, grid, _, batch) in NO_SPLIT.items()},
        'dp_cross': flux_inputs(normal, *DP_CROSS[:2], DP_CROSS[3]),
    }


def flux_inputs(normal, mkw, grid, batch):
    """(img, txt, y) of a FLUX forward at this geometry."""
    return (normal(batch, grid[0] * grid[1], mkw['in_channels']),
            normal(batch, mkw['txt_len'], mkw['context_in_dim']),
            normal(batch, mkw['vec_in_dim']))


# ----------------------------------------------------------------- worker

def run_worker(world, port, rank, inputs_path, out_path):
    """One rank of ``world``: run its checks, save the results."""
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from chipmunk_torch import parallel
    axes = WORLDS[world]
    n = int(np.prod(list(axes.values())))
    assert parallel.initialize_multihost(f'127.0.0.1:{port}', n, rank,
                                         device='cpu') == rank
    with open(inputs_path, 'rb') as f:
        I = pickle.load(f)
    mesh = parallel.make_mesh(axes)
    out = {'idempotent': np.asarray(
        parallel.initialize_multihost(device='cpu') == rank)}
    {'sp4': world_sp4, 'dp2sp2': world_dp2sp2,
     'sp2ring2': world_sp2ring2}[world](torch, mesh, I, out)
    torch.distributed.barrier()
    np.savez(out_path, **out)


def t(x):
    import torch
    return torch.from_numpy(np.ascontiguousarray(x))


def shard(x, r, n, dim=2):
    """The r-th of n equal shards of x along dim."""
    s = x.shape[dim] // n
    return np.take(x, np.arange(r * s, (r + 1) * s), axis=dim)


def flux_steps(torch, tm, params, model, sp, grid, inputs):
    """Three forward steps (FWD_STEPS) on a fresh state; their
    predictions and the state's leaf shapes.  With the batch sharded the
    predictions are this rank's batch rows."""
    from chipmunk_torch.models.flux import flux_rope_ids
    from chipmunk_torch.models.layers import build_rope
    from chipmunk_torch.parallel.sharding import local_batch
    img, txt, y = (t(a) for a in inputs)
    B = img.shape[0]
    u = sp.ulysses
    rows = local_batch(u.mesh, u.batch_axis, B)
    img, txt, y = img[rows], txt[rows], y[rows]
    b = img.shape[0]
    pe = build_rope(flux_rope_ids(b, *grid, model.txt_len, 'cpu'),
                    model.axes_dim, model.theta)
    st = sp.init_state(model, B, 'cpu')
    shapes = state_shapes(st)
    preds = []
    for fs in FWD_STEPS:
        p, st = tm.flux_forward(params, model, sp, img, txt,
                                torch.full((b,), 0.7), y, pe, st,
                                tm.FluxStep(*fs))
        preds.append(p.numpy())
    return np.stack(preds), shapes


def flux_split(torch, tm, mesh, I, out, key, geometry, batch_axis=None):
    """flux_steps at ``geometry`` (NO_SPLIT's form) sharded over sp (the
    batch over ``batch_axis``) with the MLP weights of ``fwd_params``:
    its predictions, the token split, each MLP stream's rows on this rank
    and whether the stream is routed, the state's shapes."""
    from chipmunk_torch.config import config_from_dict
    mkw, grid, ck, batch = geometry
    model = tm.FluxModelConfig(**mkw, dtype=torch.float32)
    sp = tm.FluxSparse.build(config_from_dict(ck), model,
                             model.txt_len + grid[0] * grid[1], batch=batch
                             ).with_ulysses(mesh, 'sp', batch_axis)
    params = tm.params_from_jax(I['fwd_params'], 'cpu')
    out[key], shapes = flux_steps(torch, tm, params, model, sp, grid, I[key])
    u = sp.ulysses
    out[f'{key}/sizes'] = np.asarray(u.sizes)
    out[f'{key}/mlp_rows'] = np.asarray(u.mlp_rows)
    out[f'{key}/routed'] = np.asarray([r is not None for r in u.routes])
    for name, shape in shapes.items():
        out[f'{key}/state/{name}'] = np.asarray(shape)


def state_shapes(st):
    """'field/layer/leaf' -> shape of every tensor of a state."""
    out = {}
    for name, layers in st._asdict().items():
        for i, s in enumerate(layers):
            for leaf, v in ({} if s is None else s._asdict()).items():
                if v is not None:
                    out[f'{name}/{i}/{leaf}'] = tuple(v.shape)
    return out


def world_sp4(torch, mesh, I, out):
    import chipmunk_torch.models as tm
    from chipmunk_torch import parallel
    from chipmunk_torch.config import AttnConfig, config_from_dict
    from chipmunk_torch.modules import SparseDiffAttn
    from chipmunk_torch.parallel.comm import axis_rank
    r = axis_rank(mesh, 'sp')
    # all-to-all layouts, even and uneven
    x = I['collect_x']
    ct = parallel.collect_tokens(t(shard(x, r, 4)), mesh, 'sp')
    out['even_tokens'] = ct.numpy()
    out['even_roundtrip'] = parallel.collect_heads(ct, mesh, 'sp').numpy()
    sizes = (8, 24, 16, 16)
    a = sum(sizes[:r])
    ct = parallel.collect_tokens(t(x[:, :, a:a + sizes[r]]), mesh, 'sp',
                                 sizes)
    out['uneven_tokens'] = ct.numpy()
    out['uneven_roundtrip'] = parallel.collect_heads(ct, mesh, 'sp',
                                                     sizes).numpy()

    # three steps of sparse attention, head-parallel
    q, k, v = (t(shard(z, r, 4)) for z in I['ulysses_qkv'])
    mod = SparseDiffAttn.build(AttnConfig(**ULYSSES_ATTN), 512)
    st = mod.init_state(1, 2, 32, torch.float32, 'cpu')

    def three_steps(q, k, v, st):
        o, st = mod(q, k, v, st, step_index=0, is_full=True,
                    is_colsum=False, layer_is_dense=False)
        o, st = mod(q, k, v, st, step_index=1, is_full=True,
                    is_colsum=True, layer_is_dense=False)
        return mod(q, k, v, st, step_index=2, is_full=False,
                   is_colsum=False, layer_is_dense=False)

    o, st = parallel.ulysses_attention(mesh, 'sp', three_steps, q, k, v, st)
    out['ulysses_o'] = o.numpy()
    out['ulysses_state_heads'] = np.asarray(st.out_cache.shape)

    # flux_forward on token shards (rank 0 holds text only)
    model = tm.FluxModelConfig(**FWD_MODEL, dtype=torch.float32)
    seq = model.txt_len + FWD_GRID[0] * FWD_GRID[1]
    sp = tm.FluxSparse.build(config_from_dict(FWD_CK), model, seq
                             ).with_ulysses(mesh, 'sp')
    params = tm.params_from_jax(I['fwd_params'], 'cpu')
    out['fwd'], _ = flux_steps(torch, tm, params, model, sp, FWD_GRID,
                               I['fwd'])
    out['fwd_sizes'] = np.asarray(sp.ulysses.sizes)

    # ring attention over the 4 ranks
    q, k, v = (t(shard(z, r, 4)) for z in I['ring_qkv'])
    out['ring4'] = parallel.ring_attention(mesh, 'sp', q, k, v).numpy()

    # Wan, CFG loop, sharded over sp=4 (groups of 32, and one group)
    wcfg = tm.WanModelConfig(**WAN_MODEL, dtype=torch.float32)
    lat, cc, cu = (t(a) for a in I['wan'])
    wp = tm.params_from_jax(I['wan_params'], 'cpu')
    ts = tm.get_schedule(4, wcfg.seq_len, shift=False)
    for key, ck in (('wan', WAN_CK), ('wan_one_group', WAN_ONE_GROUP_CK)):
        wm = tm.WanModel(cfg=wcfg, ck=config_from_dict(ck), device='cpu'
                         ).sharded(mesh, sp='sp')
        out[key] = tm.wan_denoise(wm, wp, lat, cc, cu, ts,
                                  generator=torch.Generator().manual_seed(3)
                                  ).numpy()
        out[f'{key}_routed'] = np.asarray(wm.mlp_route is not None)
        for name, shape in state_shapes(wm.init_state(1)).items():
            out[f'{key}_state/{name}'] = np.asarray(shape)

    # geometries with no whole-group split
    for name, geometry in NO_SPLIT.items():
        flux_split(torch, tm, mesh, I, out, f'no_split/{name}', geometry)

    # per-rank generators
    draws = []
    for _ in range(2):
        g = parallel.rank_generator(torch.Generator().manual_seed(7), mesh)
        draws.append(torch.rand(8, generator=g).numpy())
    out['rank_draws'] = np.stack(draws)
    out['base_draw'] = torch.rand(
        8, generator=torch.Generator().manual_seed(7)).numpy()


def world_dp2sp2(torch, mesh, I, out):
    import chipmunk_torch.models as tm
    from chipmunk_torch.config import config_from_dict
    model = tm.FluxModelConfig(**SAMPLER_MODEL, dtype=torch.float32)
    h, w = SAMPLER_GRID
    ck = config_from_dict(SAMPLER_CK)
    s = tm.FluxSampler(cfg=model, ck=ck, sp=tm.FluxSparse.build(
        ck, model, model.txt_len + h * w, batch=2), h_img=h, w_img=w,
        device='cpu')
    params = tm.params_from_jax(I['sampler_params'], 'cpu')
    img, txt, y = (t(a) for a in I['sampler'])
    ts = tm.get_schedule(4, h * w)
    for fsdp in (False, True):
        sh = s.sharded(mesh, sp='sp', dp='dp', fsdp=fsdp)
        out[f'sampler_fsdp{int(fsdp)}'] = sh.denoise(
            params, img, txt, y, ts,
            generator=torch.Generator().manual_seed(3)).numpy()
    out['sampler_sizes'] = np.asarray(sh.sp.ulysses.sizes)
    out['sampler_routes'] = np.asarray([r is not None
                                        for r in sh.sp.ulysses.routes])
    for name, shape in state_shapes(sh.sp.init_state(model, 2, 'cpu')
                                    ).items():
        out[f'sampler_state/{name}'] = np.asarray(shape)

    cfg = tm.HunyuanModelConfig(**HY_MODEL, dtype=torch.float32)
    hp = tm.params_from_jax(I['hunyuan_params'], 'cpu')
    lat, txt, y = (t(a) for a in I['hunyuan'])
    ts = tm.get_schedule(4, cfg.img_len, shift=False)
    base = tm.HunyuanModel(cfg=cfg, ck=config_from_dict(HY_CK), device='cpu')
    for loop, fn in (('host', tm.hunyuan_denoise),
                     ('compiled', tm.hunyuan_denoise_compiled)):
        for fsdp in (False, True):
            m = base.sharded(mesh, sp='sp', dp='dp', fsdp=fsdp)
            out[f'hunyuan_{loop}_fsdp{int(fsdp)}'] = fn(
                m, hp, lat, txt, y, ts,
                generator=torch.Generator().manual_seed(3)).numpy()
    for name, shape in state_shapes(m.init_state(2)).items():
        out[f'hunyuan_state/{name}'] = np.asarray(shape)
    routed = tm.HunyuanModel(cfg=cfg, ck=config_from_dict(HY_ROUTED_CK),
                             batch=2, device='cpu').sharded(mesh, sp='sp',
                                                            dp='dp')
    for loop, fn in (('host', tm.hunyuan_denoise),
                     ('compiled', tm.hunyuan_denoise_compiled)):
        out[f'hunyuan_routed_{loop}'] = fn(
            routed, hp, lat, txt, y, ts,
            generator=torch.Generator().manual_seed(3)).numpy()
    out['hunyuan_routed_routes'] = np.asarray(
        [r is not None for r in routed.sp.ulysses.routes])

    # a joint-sequence group across the two dp ranks' batch rows
    flux_split(torch, tm, mesh, I, out, 'dp_cross', DP_CROSS, 'dp')


def world_sp2ring2(torch, mesh, I, out):
    import chipmunk_torch.models as tm
    from chipmunk_torch import parallel
    from chipmunk_torch.config import config_from_dict
    from chipmunk_torch.parallel.comm import axis_rank
    u, r = axis_rank(mesh, 'sp'), axis_rank(mesh, 'ring')
    # USP: the sequence split over both axes, ulysses-major
    q, k, v = (t(shard(z, u * 2 + r, 4)) for z in I['usp_qkv'])
    out['usp'] = parallel.usp_attention(mesh, 'sp', 'ring', q, k, v).numpy()
    # the ring alone over its 2 ranks
    q, k, v = (t(shard(z, r, 2)) for z in I['ring_qkv'])
    out['ring2'] = parallel.ring_attention(mesh, 'ring', q, k, v).numpy()

    # uneven token shards: the forward with the sparse MLP over sp=2
    model = tm.FluxModelConfig(**FWD_MODEL, dtype=torch.float32)
    seq = model.txt_len + UNEVEN_GRID[0] * UNEVEN_GRID[1]
    sp = tm.FluxSparse.build(config_from_dict(UNEVEN_CK), model, seq
                             ).with_ulysses(mesh, 'sp')
    params = tm.params_from_jax(I['fwd_params'], 'cpu')
    out['uneven_fwd'], shapes = flux_steps(torch, tm, params, model, sp,
                                           UNEVEN_GRID, I['uneven'])
    out['uneven_sizes'] = np.asarray(sp.ulysses.sizes)
    out['uneven_routes'] = np.asarray([r is not None
                                       for r in sp.ulysses.routes])
    for name, shape in shapes.items():
        out[f'uneven_state/{name}'] = np.asarray(shape)


# ---------------------------------------------------------------- fixture

def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def jax_params():
    """The reference's weights (numpy trees) of every check."""
    import concurrent.futures

    import jax
    import jax.numpy as jnp
    from chipmunk_tpu.models import FluxModelConfig, init_flux_params
    from chipmunk_tpu.models.hunyuan import (HunyuanModelConfig,
                                             init_hunyuan_params)
    from chipmunk_tpu.models.wan import WanModelConfig, init_wan_params

    jobs = {'fwd_params': (init_flux_params, FluxModelConfig, FWD_MODEL),
            'sampler_params': (init_flux_params, FluxModelConfig,
                               SAMPLER_MODEL),
            'hunyuan_params': (init_hunyuan_params, HunyuanModelConfig,
                               HY_MODEL),
            'wan_params': (init_wan_params, WanModelConfig, WAN_MODEL)}

    def make(init, config, kw):
        return jax.tree_util.tree_map(np.asarray, init(
            jax.random.PRNGKey(0), config(**kw, dtype=jnp.float32)))

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        futs = {k: ex.submit(make, *job) for k, job in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


def jax_mesh(axes):
    import jax
    from jax.sharding import Mesh
    names = tuple(axes)
    n = int(np.prod([axes[a] for a in names]))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(
        tuple(axes[a] for a in names)), names)


def jax_references(I):
    """The reference's sharded functions on the same inputs, run a few at
    a time in threads (each is mostly compilation)."""
    import concurrent.futures

    import jax
    import jax.numpy as jnp
    from chipmunk_tpu.config import AttnConfig, config_from_dict
    from chipmunk_tpu.models import FluxModelConfig, FluxSparse
    from chipmunk_tpu.models.flux import (FluxStep, flux_forward,
                                          flux_rope_ids)
    from chipmunk_tpu.models.hunyuan import HunyuanModel, HunyuanModelConfig
    from chipmunk_tpu.models.layers import build_rope
    from chipmunk_tpu.models.sampling import FluxSampler, get_schedule
    from chipmunk_tpu.models.video_sampling import (hunyuan_denoise,
                                                    hunyuan_denoise_compiled,
                                                    wan_denoise)
    from chipmunk_tpu.models.wan import WanModel, WanModelConfig
    from chipmunk_tpu.modules import SparseDiffAttn
    from chipmunk_tpu.parallel import (ring_attention, ulysses_attention,
                                       usp_attention)
    mesh4 = jax_mesh({'sp': 4})
    mesh22 = jax_mesh({'dp': 2, 'sp': 2})

    def ulysses():
        q, k, v = (jnp.asarray(z) for z in I['ulysses_qkv'])
        mod = SparseDiffAttn.build(AttnConfig(**ULYSSES_ATTN), 512,
                                   use_kernels=False)

        def three_steps(q, k, v, st):
            o, st = mod(q, k, v, st, step_index=0, is_full=True,
                        is_colsum=False, layer_is_dense=False)
            o, st = mod(q, k, v, st, step_index=1, is_full=True,
                        is_colsum=True, layer_is_dense=False,
                        key=jax.random.PRNGKey(5))
            return mod(q, k, v, st, step_index=2, is_full=False,
                       is_colsum=False, layer_is_dense=False)

        return ulysses_attention(mesh4, 'sp', three_steps, q, k, v,
                                 mod.init_state(1, 8, 32, jnp.float32))[0]

    def fwd(grid, ck, inputs, axes, mkw=FWD_MODEL, batch=1,
            batch_axis=None):
        model = FluxModelConfig(**mkw, dtype=jnp.float32)
        seq = model.txt_len + grid[0] * grid[1]
        mesh = jax_mesh(axes)
        sp = FluxSparse.build(config_from_dict(ck), model, seq, batch=batch,
                              use_kernels=False
                              ).with_ulysses(mesh, 'sp', batch_axis)
        img, txt, y = (jnp.asarray(a) for a in inputs)
        pe = build_rope(flux_rope_ids(batch, *grid, model.txt_len),
                        model.axes_dim, model.theta)
        st = sp.init_state(model, batch)
        preds = []
        with mesh:
            for fs in FWD_STEPS:
                p, st = flux_forward(I['fwd_params'], model, sp, img, txt,
                                     jnp.full((batch,), 0.7), y, pe, st,
                                     FluxStep(*fs),
                                     key=jax.random.PRNGKey(7))
                preds.append(np.asarray(p))
        return np.stack(preds)

    def split(key, geometry, axes, batch_axis=None):
        mkw, grid, ck, batch = geometry
        return fwd(grid, ck, I[key], axes, mkw, batch, batch_axis)

    def ring():
        q, k, v = (jnp.asarray(z) for z in I['ring_qkv'])
        return ring_attention(jax_mesh({'ring': 4}), 'ring', q, k, v)

    def usp():
        q, k, v = (jnp.asarray(z) for z in I['usp_qkv'])
        return usp_attention(jax_mesh({'sp': 2, 'ring': 2}), 'sp', 'ring',
                             q, k, v)

    def sampler():
        model = FluxModelConfig(**SAMPLER_MODEL, dtype=jnp.float32)
        h, w = SAMPLER_GRID
        ck = config_from_dict(SAMPLER_CK)
        s = FluxSampler(cfg=model, ck=ck, sp=FluxSparse.build(
            ck, model, model.txt_len + h * w, batch=2, use_kernels=False),
            h_img=h, w_img=w).sharded(mesh22, sp='sp', dp='dp')
        img, txt, y = (jnp.asarray(a) for a in I['sampler'])
        return s.denoise(I['sampler_params'], img, txt, y,
                         get_schedule(4, h * w), key=jax.random.PRNGKey(3))

    def hunyuan(fn, ck=HY_CK, batch=1):
        cfg = HunyuanModelConfig(**HY_MODEL, dtype=jnp.float32)
        m = HunyuanModel(cfg=cfg, ck=config_from_dict(ck), batch=batch,
                         use_kernels=False).sharded(mesh22, sp='sp', dp='dp')
        lat, txt, y = (jnp.asarray(a) for a in I['hunyuan'])
        return fn(m, I['hunyuan_params'], lat, txt, y,
                  get_schedule(4, cfg.img_len, shift=False),
                  key=jax.random.PRNGKey(3))

    def wan(ck=WAN_CK):
        wcfg = WanModelConfig(**WAN_MODEL, dtype=jnp.float32)
        wm = WanModel(cfg=wcfg, ck=config_from_dict(ck),
                      use_kernels=False).sharded(mesh4, sp='sp')
        lat, cc, cu = (jnp.asarray(a) for a in I['wan'])
        return wan_denoise(wm, I['wan_params'], lat, cc, cu,
                           get_schedule(4, wcfg.seq_len, shift=False),
                           key=jax.random.PRNGKey(3))

    jobs = {
        'ulysses_o': ulysses,
        'fwd': lambda: fwd(FWD_GRID, FWD_CK, I['fwd'], {'sp': 4}),
        'uneven_fwd': lambda: fwd(UNEVEN_GRID, UNEVEN_CK, I['uneven'],
                                  {'sp': 2}),
        'ring': ring, 'usp': usp, 'sampler': sampler,
        'hunyuan_host': lambda: hunyuan(hunyuan_denoise),
        'hunyuan_compiled': lambda: hunyuan(hunyuan_denoise_compiled),
        'hunyuan_routed_host': lambda: hunyuan(hunyuan_denoise,
                                               HY_ROUTED_CK, 2),
        'hunyuan_routed_compiled': lambda: hunyuan(
            hunyuan_denoise_compiled, HY_ROUTED_CK, 2),
        'wan': wan,
        'wan_one_group': lambda: wan(WAN_ONE_GROUP_CK),
        'dp_cross': lambda: split('dp_cross', DP_CROSS, {'dp': 2, 'sp': 2},
                                  'dp'),
        **{f'no_split/{name}': (lambda name=name, g=g: split(
            f'no_split/{name}', g, {'sp': 4}))
           for name, g in NO_SPLIT.items()}}
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        futs = {k: ex.submit(f) for k, f in jobs.items()}
        return {k: np.asarray(f.result()) for k, f in futs.items()}


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """(inputs, per-world lists of per-rank results, reference results)."""
    tmp = tmp_path_factory.mktemp('torch_parallel')
    I = seeded_inputs()
    I.update(jax_params())
    with open(tmp / 'inputs.pkl', 'wb') as f:
        pickle.dump(I, f)
    env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1',
               PYTHONPATH=REPO)
    for k in ('JAX_PLATFORMS', 'XLA_FLAGS', 'MASTER_ADDR', 'MASTER_PORT',
              'WORLD_SIZE', 'RANK', 'LOCAL_RANK'):
        env.pop(k, None)
    procs = {}
    for world, axes in WORLDS.items():
        port = free_port()
        for r in range(int(np.prod(list(axes.values())))):
            procs[world, r] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), world,
                 str(port), str(r), str(tmp / 'inputs.pkl'),
                 str(tmp / f'{world}_{r}.npz')],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env, cwd=str(tmp))
    try:
        ref = jax_references(I)
        logs = {key: p.communicate(timeout=WORKER_TIMEOUT)[0]
                for key, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    results = {w: [] for w in WORLDS}
    for (world, r), p in procs.items():
        assert p.returncode == 0, (world, r, logs[world, r][-4000:])
        with np.load(tmp / f'{world}_{r}.npz') as z:
            results[world].append(dict(z))
    return I, results, ref


# ------------------------------------------------------------------ cases

@pytest.mark.parametrize('sizes', ['even', 'uneven'])
def test_collect_tokens_round_trip_and_layout(run, sizes):
    """After collect_tokens each rank holds every token of its heads, in
    order (the reference's layout); collect_heads gives its shard back."""
    I, res, _ = run
    x = I['collect_x']
    bounds = np.cumsum([0, 16, 16, 16, 16] if sizes == 'even'
                       else [0, 8, 24, 16, 16])
    for r, got in enumerate(res['sp4']):
        np.testing.assert_array_equal(got[f'{sizes}_tokens'],
                                      x[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got[f'{sizes}_roundtrip'],
                                      x[:, :, bounds[r]:bounds[r + 1]])


def test_ulysses_sparse_attention_matches_reference(run):
    """Full, colsum and sparse steps head-parallel over sp=4, each rank's
    state of 2 of the 8 heads."""
    _, res, ref = run
    got = np.concatenate([g['ulysses_o'] for g in res['sp4']], 2)
    np.testing.assert_allclose(got, ref['ulysses_o'], **ATTN_TOL)
    for g in res['sp4']:
        assert tuple(g['ulysses_state_heads']) == (1, 2, 512, 32)


@pytest.mark.parametrize('case', ['even', 'uneven'])
def test_flux_forward_sharded_matches_reference(run, case):
    """Three steps of flux_forward on token shards.  even: sp=4 over 512
    tokens, rank 0 holding only text; uneven: the sparse MLP on (bm 128)
    over 384 tokens on sp=2, shards of 128 and 256, the MLP caches of
    each rank's token groups."""
    _, res, ref = run
    if case == 'even':
        outs, key, want = res['sp4'], 'fwd', (128,) * 4
    else:
        outs, key, want = res['sp2ring2'], 'uneven_fwd', (128, 256)
    sizes = 'fwd_sizes' if case == 'even' else 'uneven_sizes'
    for g in outs:
        assert tuple(g[sizes]) == want
        np.testing.assert_allclose(g[key], ref[key], **ATTN_TOL)


@pytest.mark.parametrize('case', ['ring4', 'ring2', 'usp'])
def test_ring_and_usp_attention_match_reference(run, case):
    """ring4: the ring over sp=4; ring2: over the ring axis (2) of the
    sp2ring2 world; usp: all-to-all over sp, the ring inside."""
    _, res, ref = run
    world = 'sp4' if case == 'ring4' else 'sp2ring2'
    outs = [g[case] for g in res[world]]
    if case == 'ring2':     # the ring ranks of sp group 0
        outs = outs[:2]
    got = np.concatenate(outs, 2)
    # the ring's result does not depend on its size: both rings are held
    # to the reference's ring over 4
    want = ref['usp' if case == 'usp' else 'ring']
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **RING_TOL)


def test_flux_sampler_sharded_matches_reference(run):
    """FluxSampler.sharded(dp=2, sp=2): a batch of 2 over dp, uneven token
    shards (128 text tokens, then 256 image tokens), the whole result on
    every rank."""
    _, res, ref = run
    for g in res['dp2sp2']:
        assert tuple(g['sampler_sizes']) == (128, 256)
        np.testing.assert_allclose(g['sampler_fsdp0'], ref['sampler'],
                                   **LOOP_TOL)


@pytest.mark.parametrize('loop', ['host', 'compiled'])
def test_hunyuan_sharded_matches_reference(run, loop):
    _, res, ref = run
    for g in res['dp2sp2']:
        np.testing.assert_allclose(g[f'hunyuan_{loop}_fsdp0'],
                                   ref[f'hunyuan_{loop}'], **LOOP_TOL)


@pytest.mark.parametrize('loop', ['host', 'compiled'])
def test_hunyuan_routed_mlp_matches_reference(run, loop):
    """HunyuanVideo with the sparse MLP on (HY_ROUTED_CK): no whole-group
    split exists, so the tokens split evenly and both MLP streams are
    routed, the joint one over all four ranks; the host loop and the
    compiled loop (the routed all-to-alls inside its step) agree with
    the reference's sharded loops."""
    _, res, ref = run
    for g in res['dp2sp2']:
        assert list(g['hunyuan_routed_routes']) == [True, True]
        np.testing.assert_allclose(g[f'hunyuan_routed_{loop}'],
                                   ref[f'hunyuan_routed_{loop}'], **LOOP_TOL)


def test_wan_sharded_matches_reference(run):
    """The CFG pair of states a step, the batch of 1 on every rank."""
    _, res, ref = run
    for g in res['sp4']:
        np.testing.assert_allclose(g['wan'], ref['wan'], **LOOP_TOL)
        assert not g['wan_routed']


def test_wan_one_group_over_four_ranks_matches_reference(run):
    """The 128 video tokens are one MLP group of 128 for sp=4: the
    attention takes 32 tokens a rank, the MLP's rows move to the rank
    that holds the group, and the others keep no MLP state."""
    _, res, ref = run
    held = []
    for g in res['sp4']:
        np.testing.assert_allclose(g['wan_one_group'], ref['wan_one_group'],
                                   **LOOP_TOL)
        assert g['wan_one_group_routed']
        held.append(tuple(g.get('wan_one_group_state/mlp/1/out_cache', ())))
    assert sorted(held) == [()] * 3 + [(128, 256)]


@pytest.mark.parametrize('case', ['sampler', 'hunyuan_host',
                                  'hunyuan_compiled'])
def test_fsdp_equals_replicated_weights_bit_for_bit(run, case):
    _, res, _ = run
    for g in res['dp2sp2']:
        np.testing.assert_array_equal(g[f'{case}_fsdp1'], g[f'{case}_fsdp0'])


@pytest.mark.parametrize('case', ['sampler', 'hunyuan', 'wan', 'uneven'])
def test_local_state_shapes(run, case):
    """H/n heads of the rank's batch rows; the MLP caches of the rank's
    token groups, padded to whole groups."""
    _, res, _ = run
    world, n_heads, rows = {'sampler': ('dp2sp2', 2, 1),
                            'hunyuan': ('dp2sp2', 2, 1),
                            'wan': ('sp4', 1, 1),
                            'uneven': ('sp2ring2', 2, 1)}[case]
    prefix = f'{case}_state/'
    for i, g in enumerate(res[world]):
        shapes = {k[len(prefix):]: tuple(v) for k, v in g.items()
                  if k.startswith(prefix)}
        assert shapes, case
        for name, shape in shapes.items():
            if 'attn/' in name and name.endswith('out_cache'):
                assert shape[:2] == (rows, n_heads), (name, shape)
        if case in ('uneven', 'sampler'):
            # sp rank 0: the 128 text tokens, no image MLP; sp rank 1: 256
            # image tokens (world ranks are dp- or sp-major)
            first = (i // 2 if case == 'uneven' else i % 2) == 0
            assert shapes['single_mlp/0/out_cache'] == (
                128 if first else 256, 256)
            assert ('double_mlp/0/out_cache' in shapes) != first
        if case == 'wan':
            assert shapes['mlp/1/out_cache'] == (32, 256)


@pytest.mark.parametrize('world', list(WORLDS))
def test_initialize_multihost_is_idempotent(run, world):
    _, res, _ = run
    assert all(bool(g['idempotent']) for g in res[world])


def test_rank_generators_differ_and_repeat(run):
    """Rank 0 draws what the caller's generator draws; every rank draws
    the same on each run, and no two ranks alike."""
    _, res, _ = run
    draws = [g['rank_draws'] for g in res['sp4']]
    for d in draws:
        np.testing.assert_array_equal(d[0], d[1])
    np.testing.assert_array_equal(draws[0][0], res['sp4'][0]['base_draw'])
    firsts = [tuple(d[0]) for d in draws]
    assert len(set(firsts)) == len(firsts)


def check_routed_split(outs, key, want, rows_of, seq_len, streams):
    """Each rank's predictions against the reference's (``rows_of(i)``:
    rank i's batch rows), the even token split, and the MLP streams
    (name -> (routed, stream rows to cover)): a routed stream's rows
    dealt out once over the ranks that hold it, in whole groups of
    256 or 128 rows (the last one short), and a rank without rows
    keeping no MLP state."""
    n = len(outs[0][f'{key}/sizes'])
    even = [seq_len // n + (r < seq_len % n) for r in range(n)]
    for i, g in enumerate(outs):
        np.testing.assert_allclose(g[key], want[:, rows_of(i)], **ATTN_TOL)
        assert sorted(g[f'{key}/sizes']) == sorted(even)
        routed = list(g[f'{key}/routed'])
        assert routed == [streams[s][0] for s in ('joint', 'image')]
        for j, field in ((0, 'single_mlp'), (1, 'double_mlp')):
            held = f'{key}/state/{field}/0/out_cache' in g
            assert held == (int(g[f'{key}/mlp_rows'][j]) > 0)
    for j, s in enumerate(('joint', 'image')):
        routed, total = streams[s]
        if routed:
            assert sum(int(g[f'{key}/mlp_rows'][j]) for g in outs) == total


@pytest.mark.parametrize('case', list(NO_SPLIT))
def test_no_whole_group_split_raises(run, case):
    """Where no split in whole MLP token groups exists (this test's name
    is from when the port refused these geometries), the tokens split as
    evenly as they allow over sp=4, each MLP stream whose groups that
    split cuts moves to a whole-group split of its own, and three steps
    agree with the reference's sharded forward (which runs the MLP on
    the global token axis)."""
    I, res, ref = run
    mkw, grid, ck, batch = NO_SPLIT[case]
    n_img = grid[0] * grid[1]
    streams = {'fewer_groups_than_ranks': {'joint': (True, 384),
                                           'image': (True, 256)},
               'image_groups_cut': {'joint': (True, 896),
                                    'image': (True, 768)},
               'batch_fold_cut': {'joint': (True, 2 * 896),
                                  'image': (True, 2 * 640)}}[case]
    check_routed_split(res['sp4'], f'no_split/{case}',
                       ref[f'no_split/{case}'], lambda i: slice(None),
                       mkw['txt_len'] + n_img, streams)


def test_group_crossing_dp_ranks_matches_reference(run):
    """dp=2 x sp=2 with a batch of 2: a joint-sequence MLP group holds
    rows of both dp ranks' batch rows, so that stream is dealt out over
    all four ranks; the image stream's groups stay within a dp rank and
    move over its sp pair (256 rows on each dp rank)."""
    _, res, ref = run
    check_routed_split(res['dp2sp2'], 'dp_cross', ref['dp_cross'],
                       lambda i: slice(i // 2, i // 2 + 1), 384,
                       {'joint': (True, 2 * 384), 'image': (True, 2 * 256)})


@pytest.mark.parametrize('world,key', [('sp2ring2', 'uneven'),
                                       ('dp2sp2', 'sampler')])
def test_whole_group_splits_route_nothing(run, world, key):
    """Where a whole-group split exists it is kept, and no MLP row moves:
    the sampler's and the uneven forward's streams have no route."""
    _, res, _ = run
    for g in res[world]:
        assert not any(g[f'{key}_routes'])


def test_sharded_entry_points_need_a_process_group():
    """Without a process group nothing runs single-rank: the mesh and the
    placement raise."""
    import torch.distributed as dist
    from chipmunk_torch import parallel
    from chipmunk_torch.parallel.sharding import place_video_inputs
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match='process group'):
        parallel.make_mesh({'sp': 1})
    with pytest.raises(RuntimeError, match='process group'):
        place_video_inputs(None, {}, (), None)


def test_fsdp_shardings_follow_the_reference_rule():
    """The largest dim the axis size divides, replicated where none does;
    QTensor planes and scales apart."""
    import types

    import torch
    from chipmunk_torch import parallel
    from chipmunk_torch.parallel.sharding import _fsdp_dim
    from chipmunk_torch.utils.quant import QTensor

    class Mesh:     # the one axis, of 4 ranks, that fsdp_shardings reads
        def __getitem__(self, axis):
            return types.SimpleNamespace(size=lambda: 4)

    tree = {'w': torch.zeros(6, 8), 'b': torch.zeros(6), 'n': torch.zeros(3),
            'q': QTensor(torch.zeros(16, 12, dtype=torch.int8),
                         torch.zeros(16, 1))}
    dims = parallel.fsdp_shardings(tree, Mesh(), 'sp')
    assert dims['w'] == 1 and dims['b'] is None and dims['n'] is None
    assert dims['q'].q == 0 and dims['q'].scale == 0
    assert _fsdp_dim((8, 8), 4) == 0 and _fsdp_dim((), 4) is None


if __name__ == '__main__':
    try:
        run_worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)
