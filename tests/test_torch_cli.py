"""The port's generate CLIs (``python -m chipmunk_torch.cli.<name>``), as
tests/test_cli_checkpoints.py drives the JAX ones: each twin runs as a
subprocess with ``--tiny --device cpu --ckpt <file>`` (a .safetensors
file in the reference's key layout, written by the port's writer), its
latents finite, of their shape and equal to a direct call of its
``generate`` with the same seed; the HunyuanVideo twin takes the streamed
runner when the config offloads; the HunyuanVideo and Wan twins encode
their prompts with tiny local encoders (config.json, safetensors and a
tokenizer saved with transformers, nothing downloaded) and equal a direct
``generate`` on the holders' output; ``--profile`` and ``should_profile``
write a trace where the reference's gate says; the video twins run
sharded as two processes joined by the multi-host flags (``--mesh
sp=2``) and equal the one-process twin, and a mesh they cannot run
exits non-zero naming its numbers; and one FLUX pipeline, from
the checkpoint file to the latent under ``mlp.is_fp8``, against the
reference's loader and loop fed the same numpy noise (jax.random cannot
be reproduced), float32, TOL."""
import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chipmunk_torch.cli import flux_generate, hunyuan_generate, wan_generate
from chipmunk_torch.config import config_from_dict, load_config
from chipmunk_torch.models import (HunyuanModel, WanModel,
                                   load_flux_safetensors,
                                   load_hunyuan_safetensors,
                                   load_wan_safetensors)
from chipmunk_torch.utils.safetensors_io import save_file
from test_loaders import (synth_hunyuan_state_dict, synth_state_dict,
                          synth_wan_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 on both sides: summation order only
TOL = dict(atol=1e-4, rtol=1e-4)
# one CPU thread in the twins and in the direct calls they are held to, so
# that both sum in the same order
THREADS = 1


@contextlib.contextmanager
def threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def run_twin(name, args, check=True, cwd=REPO, stdin=None):
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS),
               MKL_NUM_THREADS=str(THREADS), PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-m', f'chipmunk_torch.cli.{name}',
                        *args], capture_output=True, text=True, timeout=600,
                       env=env, cwd=cwd, input=stdin)
    if check:
        assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r


FLUX_TINY = ['--tiny', '--depth', '1', '--depth-single', '1', '--steps', '2',
             '--width', '256', '--height', '256', '--out', 'lat.npy']
HY_TINY = ['--tiny', '--depth', '1', '--depth-single', '2', '--steps', '2',
           '--video-size', '128', '128', '--video-length', '5',
           '--out', 'lat.npy']
WAN_TINY = ['--tiny', '--layers', '2', '--steps', '2', '--size', '128',
            '128', '--frames', '5', '--out', 'lat.npy']


def trace_files(d):
    d = os.path.join(d, 'profiles')
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def write_ckpt(sd, path):
    save_file({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return str(path)


def check_latents(path, shape):
    out = np.load(path)
    assert out.dtype == np.float32 and out.shape == shape
    assert np.isfinite(out).all() and out.std() > 0
    return out


def test_flux_twin_from_checkpoint_matches_generate(tmp_path):
    """--tiny at --depth 1 --depth-single 1, 2 steps, 256x256."""
    model = flux_generate.model_config(1, 1, tiny=True, device='cpu')
    ckpt = write_ckpt(synth_state_dict(model, np.random.default_rng(0)),
                      tmp_path / 'flux.safetensors')
    out = tmp_path / 'lat.npy'
    r = run_twin('flux_generate', [
        '--tiny', '--device', 'cpu', '--ckpt', ckpt, '--depth', '1',
        '--depth-single', '1', '--steps', '2', '--width', '256',
        '--height', '256', '--seed', '3', '--out', str(out)])
    assert 'random weights' not in r.stdout
    got = check_latents(out, (1, 256, 64))
    ck = config_from_dict({'steps': 2})
    with threads(THREADS):
        want = flux_generate.generate(
            load_flux_safetensors(ckpt, model, ck=ck, device='cpu'), model,
            ck, width=256, height=256, seed=3, device='cpu')
    np.testing.assert_array_equal(got, want.numpy())


def hunyuan_case(tmp_path):
    cfg = hunyuan_generate.model_config((128, 128), 5, 1, 2, tiny=True,
                                        device='cpu')
    ckpt = write_ckpt(synth_hunyuan_state_dict(cfg, np.random.default_rng(1)),
                      tmp_path / 'hy.safetensors')
    return cfg, ckpt, ['--tiny', '--device', 'cpu', '--ckpt', ckpt,
                       '--depth', '1', '--depth-single', '2', '--steps', '2',
                       '--video-size', '128', '128', '--video-length', '5']


@pytest.mark.parametrize('config', [None, 'configs/hunyuan-chipmunk.yml'])
def test_hunyuan_twin_takes_the_streamed_runner(config, tmp_path):
    """Both the default config and the shipped one offload the attention
    caches: the twin says it takes the streamed runner, and its latents
    equal the resident host loop's (the shipped config) or the streamed
    generate's (the default)."""
    cfg, ckpt, args = hunyuan_case(tmp_path)
    out = tmp_path / 'lat.npy'
    extra = ['--chipmunk-config', config] if config else []
    r = run_twin('hunyuan_generate', args + extra + ['--out', str(out)])
    assert 'streamed (host-offload) runner' in r.stdout
    got = check_latents(out, (1, 16, 2, 16, 16))
    ck = (load_config(os.path.join(REPO, config)) if config
          else config_from_dict({})).replace(steps=2)
    with threads(THREADS):
        model = HunyuanModel(cfg=cfg, ck=ck, device='cpu')
        params = load_hunyuan_safetensors(ckpt, cfg, device='cpu')
        if config:
            want = hunyuan_generate.generate(model, params, compiled=False)
        else:
            want = hunyuan_generate.generate(model, params,
                                             streamed=model.make_streamed())
    np.testing.assert_array_equal(got, want.numpy())


def test_wan_twin_from_checkpoint_matches_generate(tmp_path):
    cfg = wan_generate.model_config((128, 128), 5, 2, tiny=True,
                                    device='cpu')
    ckpt = write_ckpt(synth_wan_state_dict(cfg, np.random.default_rng(2)),
                      tmp_path / 'wan.safetensors')
    out = tmp_path / 'lat.npy'
    run_twin('wan_generate', [
        '--tiny', '--device', 'cpu', '--ckpt', ckpt, '--layers', '2',
        '--steps', '2', '--size', '128', '128', '--frames', '5', '--seed',
        '5', '--out', str(out)])
    got = check_latents(out, (1, 16, 2, 16, 16))
    ck = config_from_dict({'num_model_invocations_per_inference_step': 2,
                           'steps': 2})
    with threads(THREADS):
        model = WanModel(cfg=cfg, ck=ck, device='cpu')
        want = wan_generate.generate(
            model, load_wan_safetensors(ckpt, cfg, device='cpu'), seed=5)
    np.testing.assert_array_equal(got, want.numpy())


REFUSED = [
    ('flux_generate', ['--prompt', 'a cat'], '--t5 and --clip'),
]


@pytest.mark.parametrize('name,flags,says', REFUSED)
def test_twins_refuse_what_waits_for_unported_parts(name, flags, says):
    """Refused before any model is built; nothing falls back to zero text
    when a prompt was asked for."""
    mod = {'flux_generate': flux_generate,
           'hunyuan_generate': hunyuan_generate,
           'wan_generate': wan_generate}[name]
    with pytest.raises(SystemExit) as e:
        mod.main(['--device', 'cpu', '--tiny', *flags])
    assert says in str(e.value.code)


MESH_REFUSED = [
    ('hunyuan_generate', ['--mesh', 'sp=2'], 'needs 2 ranks, the world has 1'),
    ('wan_generate', ['--mesh', 'dp=2,sp=2'],
     'needs 4 ranks, the world has 1'),
    ('hunyuan_generate', ['--mesh', 'sp=4'], 'num_heads=2 not divisible'),
    ('wan_generate', ['--mesh', 'tp=2'], 'axes dp and sp'),
    ('hunyuan_generate', ['--mesh', 'sp=1', '--chipmunk-config',
                          os.path.join(REPO, 'configs',
                                       'hunyuan-chipmunk.yml')],
     'mutually exclusive'),
    ('wan_generate', ['--multihost', '--coordinator', '127.0.0.1:1',
                      '--num-processes', '2'],
     '--coordinator needs --num-processes and --process-id'),
]


@pytest.mark.parametrize('name,flags,says', MESH_REFUSED)
def test_twins_refuse_a_mesh_they_cannot_run(name, flags, says):
    """A mesh the world cannot hold, an sp the heads do not split over,
    an unknown axis, a mesh with an offloading config, a coordinator
    without the world's size: refused before any model or process group
    is made."""
    import torch.distributed as dist
    mod = {'hunyuan_generate': hunyuan_generate,
           'wan_generate': wan_generate}[name]
    with pytest.raises(SystemExit) as e:
        mod.main(['--device', 'cpu', '--tiny', *flags])
    assert says in str(e.value.code)
    assert not dist.is_initialized()


def run_world(name, args, n, cwd):
    """The twin as ``n`` processes joined by the multi-host flags on a
    free local port, ``--mesh sp=n``; every process must exit 0."""
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS),
               MKL_NUM_THREADS=str(THREADS), PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, '-m', f'chipmunk_torch.cli.{name}', *args,
         '--multihost', '--coordinator', f'127.0.0.1:{port}',
         '--num-processes', str(n), '--process-id', str(i), '--mesh',
         f'sp={n}'], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=cwd) for i in range(n)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


@pytest.mark.parametrize('name', ['hunyuan_generate', 'wan_generate'])
def test_two_process_twin_equals_one_process_twin(name, tmp_path):
    """--tiny with --mesh sp=2 over two processes (the HunyuanVideo
    twin's default config drops its offloading under --mesh): rank 0
    alone writes and says where, and the latents equal the one-process
    twin's."""
    args = (['--tiny', '--device', 'cpu', '--depth', '1', '--depth-single',
             '2', '--steps', '2', '--video-size', '128', '128',
             '--video-length', '5'] if name == 'hunyuan_generate'
            else ['--tiny', '--device', 'cpu', '--layers', '2', '--steps',
                  '2', '--size', '128', '256', '--frames', '5'])
    logs = run_world(name, args + ['--out', 'two.npy'], 2, str(tmp_path))
    assert 'latents -> two.npy' in logs[0]
    assert 'latents ->' not in logs[1] and 'mesh sp=2' not in logs[1]
    run_twin(name, args + ['--out', 'one.npy'], cwd=str(tmp_path))
    one = check_latents(tmp_path / 'one.npy', np.load(
        tmp_path / 'two.npy').shape)
    np.testing.assert_allclose(np.load(tmp_path / 'two.npy'), one, **TOL)


def test_refusal_exits_non_zero_and_a_gpu_is_needed(tmp_path, monkeypatch):
    r = run_twin('wan_generate', ['--device', 'cpu', '--mesh', 'sp=4'],
                 check=False)
    assert r.returncode != 0 and 'needs 4 ranks, the world has 1' in r.stderr
    assert not os.path.exists(os.path.join(REPO, 'wan_latents.npy'))
    # a config asking for a trace is taken: the trace goes to ./profiles
    yml = tmp_path / 'prof.yml'
    yml.write_text('should_profile: true\ngeneration_index: 3\n')
    monkeypatch.chdir(tmp_path)
    with threads(2):
        flux_generate.main(['--device', 'cpu', '--chipmunk-config',
                            str(yml)] + FLUX_TINY)
    assert trace_files(tmp_path) and os.path.exists('lat.npy')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for mod in (flux_generate, hunyuan_generate, wan_generate):
        with pytest.raises(RuntimeError, match='CUDA'):
            mod.main(['--tiny'])


def test_flux_pipeline_from_checkpoint_matches_reference(tmp_path):
    """mlp.is_fp8: the checkpoint file through each side's loader (int8
    sparse MLP and fp8 text MLP weights), then 6 steps (full, colsum,
    sparse with and without MLP re-selection, a skipped step) through
    the twin's generate and through the reference's FluxSampler, the
    same numpy noise, random keeps off on both sides."""
    from chipmunk_tpu.config import config_from_dict as j_config_from_dict
    from chipmunk_tpu.models import FluxModelConfig as JModel
    from chipmunk_tpu.models import FluxSparse as JSparse
    from chipmunk_tpu.models.loaders import load_flux_safetensors as j_load
    from chipmunk_tpu.models.sampling import FluxSampler as JSampler
    from chipmunk_tpu.models.sampling import get_schedule as j_get_schedule
    from chipmunk_torch.models import FluxModelConfig
    kw = dict(in_channels=64, vec_in_dim=32, context_in_dim=32,
              hidden_size=128, num_heads=1, mlp_ratio=4.0, depth=2,
              depth_single_blocks=1, axes_dim=(16, 56, 56),
              guidance_embed=True, txt_len=128)
    jm, tm = JModel(**kw, dtype=jnp.float32), \
        FluxModelConfig(**kw, dtype=torch.float32)
    d = {'steps': 6,
         'attn': {'top_keys': 0.4, 'kv_block': 32, 'counts_multiple_of': 32,
                  'first_n_dense_layers': 1, 'random_keys': 0.0,
                  'should_compress_indices': False, 'full_step_every': 4},
         'mlp': {'is_fp8': True, 'top_keys': 0.5, 'neuron_block': 128,
                 'bm': 128, 'counts_multiple_of': 128, 'random_keys': 0.0,
                 'first_n_dense_layers': 1, 'full_step_every': 4},
         'patchify': {'chunk_size_1': 4, 'chunk_size_2': 2},
         'step_caching': {'is_enabled': True, 'skip_step_schedule': {3}}}
    jck, ck = j_config_from_dict(d), config_from_dict(d)
    ckpt = write_ckpt(synth_state_dict(tm, np.random.default_rng(7)),
                      tmp_path / 'flux.safetensors')
    h_img, w_img = 8, 16
    rng = np.random.default_rng(8)
    img = rng.standard_normal((1, h_img * w_img, 64)).astype(np.float32)
    txt = rng.standard_normal((1, 128, 32)).astype(np.float32)
    y = rng.standard_normal((1, 32)).astype(np.float32)
    jsp = JSparse.build(jck, jm, 128 + h_img * w_img, use_kernels=False)
    js = JSampler(cfg=jm, ck=jck, sp=jsp, h_img=h_img, w_img=w_img)
    out_j = js.denoise(j_load(ckpt, jm, ck=jck),
                       *map(jnp.asarray, (img, txt, y)),
                       j_get_schedule(6, h_img * w_img), guidance=3.5,
                       key=jax.random.PRNGKey(0))
    params = load_flux_safetensors(ckpt, tm, ck=ck, device='cpu')
    assert params['single'][0]['w1t'].q.dtype == torch.int8
    out_t = flux_generate.generate(
        params, tm, ck, width=16 * w_img, height=16 * h_img, guidance=3.5,
        txt=torch.from_numpy(txt), y=torch.from_numpy(y),
        img=torch.from_numpy(img), device='cpu')
    assert out_t.shape == img.shape and torch.isfinite(out_t).all()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


# the flags whose refusals went with the text encoders and the profiler:
# each is taken now (a prompt without its encoders warns and runs on
# zeros, as the reference's CLIs do)
TAKEN = [
    ('flux_generate', ['--profile'], None),
    ('hunyuan_generate', ['--prompt', 'a cat'], 'without --llm/--clip'),
    ('hunyuan_generate', ['--llm', 'llm', '--prompt', 'a cat'],
     'without --llm/--clip'),
    ('hunyuan_generate', ['--clip', 'clip'], None),
    ('wan_generate', ['--prompt', 'a cat'], 'without --umt5/--tokenizer'),
    ('wan_generate', ['--umt5', 'umt5.pth'], None),
    ('wan_generate', ['--tokenizer', 'tok', '--prompt', 'a cat'],
     'without --umt5/--tokenizer'),
    ('wan_generate', ['--neg-prompt', 'blurry'], None),
]


@pytest.mark.parametrize('name,flags,warns', TAKEN)
def test_twins_take_the_text_and_profile_flags(name, flags, warns, tmp_path,
                                               monkeypatch, capsys):
    mod, tiny = {'flux_generate': (flux_generate, FLUX_TINY),
                 'hunyuan_generate': (hunyuan_generate, HY_TINY),
                 'wan_generate': (wan_generate, WAN_TINY)}[name]
    monkeypatch.chdir(tmp_path)
    with threads(2):
        assert mod.main(['--device', 'cpu', *tiny, *flags]) == 0
    err = capsys.readouterr().err
    assert (warns in err) if warns else 'zero embeddings' not in err
    assert np.isfinite(np.load(tmp_path / 'lat.npy')).all()
    assert bool(trace_files(tmp_path)) == ('--profile' in flags)


def test_hunyuan_twin_encodes_prompts_with_local_encoders(tmp_path):
    """--llm/--clip (LLaMA at the model's text width 4096, 3 layers, so
    the skip-2 selection runs one; CLIP at width 768) with --prompt and
    one --interactive prompt: each generation equals generate() on the
    holder's (txt, txt_mask, y) with the next seed; should_profile at
    generation_index 2 traces the second generation only."""
    from chipmunk_torch.models import HunyuanTextEncoders, VIDEO_CROP_START
    from test_torch_text_wrappers import write_clip_dir, write_llm_dir
    write_llm_dir(tmp_path / 'llm', hidden=4096, layers=3, heads=32, kv=1,
                  ffn=64, dtype=torch.bfloat16)
    write_clip_dir(tmp_path / 'clip', width=768, layers=1, heads=12)
    cfg, ckpt, args = hunyuan_case(tmp_path)
    yml = tmp_path / 'prof.yml'
    yml.write_text('should_profile: true\ngeneration_index: 2\n')
    r = run_twin('hunyuan_generate', args + [
        '--llm', str(tmp_path / 'llm'), '--clip', str(tmp_path / 'clip'),
        '--prompt', 'a red fox runs', '--interactive', '--chipmunk-config',
        str(yml), '--out', str(tmp_path / 'lat.npy')], cwd=tmp_path,
        stdin='the quick brown dog\n')
    assert 'zero embeddings' not in r.stderr
    assert len(trace_files(tmp_path)) == 1
    ck = load_config(str(yml)).replace(steps=2)
    with threads(THREADS):
        model = HunyuanModel(cfg=cfg, ck=ck, device='cpu')
        params = load_hunyuan_safetensors(ckpt, cfg, device='cpu')
        enc = HunyuanTextEncoders(str(tmp_path / 'llm'),
                                  str(tmp_path / 'clip'),
                                  max_length=cfg.txt_len + VIDEO_CROP_START,
                                  dtype=torch.float32, device='cpu')
        streamed = model.make_streamed()
        for i, (prompt, out) in enumerate((('a red fox runs', 'lat.npy'),
                                           ('the quick brown dog',
                                            'lat_1.npy'))):
            txt, mask, y = enc.embed([prompt])
            assert txt.shape == (1, 32, 4096) and y.shape == (1, 768)
            assert 0 < int(mask.sum()) < 32
            want = hunyuan_generate.generate(model, params, seed=i, txt=txt,
                                             y=y, txt_mask=mask,
                                             streamed=streamed)
            got = check_latents(tmp_path / out, (1, 16, 2, 16, 16))
            np.testing.assert_array_equal(got, want.numpy())
        zero = hunyuan_generate.generate(model, params, seed=0,
                                         streamed=model.make_streamed())
    assert not np.array_equal(zero.numpy(), np.load(tmp_path / 'lat.npy'))


def test_wan_twin_encodes_prompts_with_a_local_encoder(tmp_path):
    """--umt5 (a .safetensors at the model's text width 4096) and
    --tokenizer with --prompt and --neg-prompt: equal to generate() on
    WanTextEncoder's cond and uncond rows; should_profile at
    generation_index 3 writes a trace."""
    from chipmunk_torch.models import WanTextEncoder
    from test_torch_text_wrappers import write_umt5
    write_umt5(tmp_path / 'umt5.safetensors', tmp_path / 'tok', dim=4096)
    cfg = wan_generate.model_config((128, 128), 5, 2, tiny=True,
                                    device='cpu')
    ckpt = write_ckpt(synth_wan_state_dict(cfg, np.random.default_rng(4)),
                      tmp_path / 'wan.safetensors')
    yml = tmp_path / 'prof.yml'
    yml.write_text('should_profile: true\ngeneration_index: 3\n'
                   'num_model_invocations_per_inference_step: 2\n')
    run_twin('wan_generate', [
        '--device', 'cpu', '--ckpt', ckpt, *WAN_TINY[:-2], '--seed', '2',
        '--umt5', str(tmp_path / 'umt5.safetensors'), '--tokenizer',
        str(tmp_path / 'tok'), '--prompt', 'a red fox', '--neg-prompt',
        'blurry dog', '--chipmunk-config', str(yml), '--out',
        str(tmp_path / 'lat.npy')], cwd=tmp_path)
    assert len(trace_files(tmp_path)) == 1
    ck = load_config(str(yml)).replace(steps=2)
    with threads(THREADS):
        enc = WanTextEncoder(str(tmp_path / 'umt5.safetensors'),
                             str(tmp_path / 'tok'), text_len=cfg.txt_len,
                             dtype=torch.float32, device='cpu')
        ctx = enc.embed(['a red fox', 'blurry dog'])
        assert ctx[0, :4].abs().sum(-1).all() and not ctx[0, 4:].any()
        model = WanModel(cfg=cfg, ck=ck, device='cpu')
        want = wan_generate.generate(
            model, load_wan_safetensors(ckpt, cfg, device='cpu'), seed=2,
            ctx_cond=ctx[:1], ctx_uncond=ctx[1:])
    got = check_latents(tmp_path / 'lat.npy', (1, 16, 2, 16, 16))
    np.testing.assert_array_equal(got, want.numpy())
