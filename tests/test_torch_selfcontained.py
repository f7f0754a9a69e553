"""chipmunk_torch stands alone: it imports neither jax nor chipmunk_tpu
(nor safetensors, nor, at import, transformers or tokenizers: the card's
machine has none of them), and its entry points refuse to run without a
GPU unless asked for the CPU."""
import os
import pkgutil
import re
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'chipmunk_torch')
MODULES = sorted(m.name for m in pkgutil.walk_packages([PKG],
                                                        'chipmunk_torch.'))
FORBIDDEN = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|chipmunk_tpu)\b',
                       re.M)


def test_every_module_imports_with_jax_and_reference_blocked():
    code = textwrap.dedent(f'''
        import importlib, importlib.abc, sys

        BLOCKED = ('jax', 'jaxlib', 'chipmunk_tpu', 'safetensors',
                   'transformers', 'tokenizers')

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split('.')[0] in BLOCKED:
                    raise ImportError('blocked: ' + name)

        sys.meta_path.insert(0, Block())
        for m in {MODULES!r}:
            importlib.import_module(m)
        bad = [m for m in sys.modules if m.split('.')[0] in BLOCKED]
        assert not bad, bad
        # importing compiled and loaded no kernel library
        assert not sys.modules['chipmunk_torch.kernels._build']._libs
        # and made no process group
        import torch.distributed as dist
        assert not dist.is_initialized()
        print('ok', len({MODULES!r}))
        ''')
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f'ok {len(MODULES)}'
    assert 'chipmunk_torch.kernels.csp_mlp' in MODULES
    assert 'chipmunk_torch.models.sampling' in MODULES
    assert 'chipmunk_torch.utils.quant' in MODULES
    assert 'chipmunk_torch.kernels.int8_probe' in MODULES
    assert 'chipmunk_torch.models.video_sampling' in MODULES
    assert 'chipmunk_torch.ops.voxel' in MODULES
    assert 'chipmunk_torch.models.wan' in MODULES
    assert 'chipmunk_torch.models.video_encoders' in MODULES
    assert 'chipmunk_torch.models.step_graphs' in MODULES
    for m in ('flux_encoders', 'encoders', 'autoencoder', 'video_vae',
              'loaders'):
        assert f'chipmunk_torch.models.{m}' in MODULES
    for m in ('modules.mlp_fp8', 'utils.safetensors_io', 'cli',
              'cli.flux_generate', 'cli.hunyuan_generate',
              'cli.wan_generate', 'models.llama', 'utils.profiling',
              'parallel', 'parallel.comm', 'parallel.ring',
              'parallel.sharding', 'utils.checkpoint', 'utils.native'):
        assert f'chipmunk_torch.{m}' in MODULES


def test_no_jax_or_reference_imports_in_sources():
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    hits = [f for f in files if FORBIDDEN.search(open(f).read())]
    assert not hits, hits


def test_no_module_of_the_port_imports_safetensors():
    """Checkpoints are read with utils/safetensors_io: the card's machine
    has no safetensors package."""
    pattern = re.compile(r'^\s*(import|from)\s+safetensors\b', re.M)
    files = [os.path.join(root, n) for root, _, names in os.walk(PKG)
             for n in names if n.endswith('.py')]
    assert len(files) > 40
    hits = [f for f in files if pattern.search(open(f).read())]
    assert not hits, hits


def test_entry_points_need_a_gpu_unless_asked_for_cpu(monkeypatch):
    from chipmunk_torch.config import config_from_dict
    from chipmunk_torch.device import resolve_device
    from chipmunk_torch.models import (FluxModelConfig, FluxSampler,
                                       FluxSparse, HunyuanModel,
                                       HunyuanModelConfig, init_flux_params,
                                       init_hunyuan_params, params_from_jax)
    from chipmunk_torch.modules.mlp_fp8 import init_input_state
    from chipmunk_torch.utils.quant import synth_quantized_flux_params
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    tiny = FluxModelConfig(hidden_size=128, num_heads=2, depth=1,
                           depth_single_blocks=1, txt_len=128,
                           axes_dim=(16, 24, 24), context_in_dim=32,
                           vec_in_dim=32, in_channels=16,
                           dtype=torch.float32)
    video = HunyuanModelConfig(latent_t=4, latent_h=8, latent_w=16,
                               hidden_size=128, num_heads=2, depth_double=1,
                               depth_single=1, text_dim=64, vec_in_dim=32,
                               axes_dim=(16, 24, 24), dtype=torch.float32)
    ck = config_from_dict({'attn': {'should_compress_indices': False}})
    sp = FluxSparse.build(ck, tiny, 512)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: init_flux_params(gen, tiny),
                 lambda: sp.init_state(tiny, 1),
                 lambda: params_from_jax({}),
                 lambda: FluxSampler(cfg=tiny, ck=ck, sp=sp, h_img=16,
                                     w_img=24),
                 lambda: synth_quantized_flux_params(0, tiny),
                 lambda: init_hunyuan_params(gen, video),
                 lambda: HunyuanModel(cfg=video, ck=ck),
                 lambda: init_input_state(),
                 lambda: resolve_device()):
        with pytest.raises(RuntimeError, match='CUDA'):
            call()
    assert init_flux_params(gen, tiny, device='cpu')['img_in']['w'] \
        .device.type == 'cpu'
    assert sp.init_state(tiny, 1, device='cpu').double_attn[0] is not None
    FluxSampler(cfg=tiny, ck=ck, sp=sp, h_img=16, w_img=24, device='cpu')


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The CPU takes the plain version; a tensor the kernels cannot take
    (here: a meta tensor, neither CPU nor CUDA) is refused, not run."""
    from chipmunk_torch.kernels import csp_attn, csp_mlp_mm1, dense_attn
    q = torch.empty((1, 1, 128, 128), device='meta')
    with pytest.raises(ValueError):
        dense_attn(q, q, q)
    inds = torch.zeros((1, 1, 1, 1), dtype=torch.int32, device='meta')
    counts = torch.ones((1, 1, 1), dtype=torch.int32, device='meta')
    with pytest.raises(ValueError):
        csp_attn(q, q, q, inds, counts)
    # indices on another device than the activations, a short bias
    qc = torch.zeros((1, 1, 128, 128))
    with pytest.raises(ValueError, match='device'):
        csp_attn(qc, qc, qc, inds, counts)
    x, w = torch.zeros((128, 128)), torch.zeros((256, 128))
    act = torch.zeros((128, 256))
    with pytest.raises(ValueError, match='device'):
        csp_mlp_mm1(x, w, torch.zeros(256), act, inds[0, 0], counts[0, 0])
    with pytest.raises(ValueError, match='shapes'):
        csp_mlp_mm1(x, w, torch.zeros(128), act,
                    torch.zeros((1, 1), dtype=torch.int32),
                    torch.ones(1, dtype=torch.int32))


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: chip_smoke.py would run for real')
    for cwd, script in ((REPO, os.path.join(REPO, 'chip_smoke.py')),
                        (tmp_path, tmp_path / 'chip_smoke.py')):
        if cwd == tmp_path:
            (tmp_path / 'chip_smoke.py').write_text(
                open(os.path.join(REPO, 'chip_smoke.py')).read())
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and r.stdout == ''


def test_unported_attention_paths_raise():
    """Compressed indices, static masks (with the dense tail) and
    valid_len, which raised before this port had them, now build."""
    from chipmunk_torch.config import AttnConfig
    from chipmunk_torch.modules import SparseDiffAttn
    cfg = AttnConfig(should_compress_indices=True, dense_fallback_frac=1.0)
    mod = SparseDiffAttn.build(cfg, 512, valid_len=500,
                               static_mask_tokens=torch.ones(4, 512,
                                                             dtype=bool))
    assert mod.valid_len == 500 and mod.dense_tail_g == 0
    st = mod.init_state(1, 2, 128, torch.float32, device='cpu')
    assert st.inds is not None and st.packed.shape == (1, 2, 4, 1)
