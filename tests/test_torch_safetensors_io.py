"""chipmunk_torch.utils.safetensors_io, the port's own reader and writer of
the safetensors format, against the ``safetensors`` package: every dtype
read back bit for bit equal to ``safetensors.torch.load_file``, the
port's files read by ``safe_open`` (metadata included), prefixes and
shard directories, refusals; and with ``import safetensors`` blocked, the
T5, CLIP, FLUX AE and HunyuanVideo VAE loaders still read files the test
wrote."""
import json
import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import safetensors.torch
import torch

from chipmunk_torch.models import flux_encoders as tfe
from chipmunk_torch.models import loaders as tld
from chipmunk_torch.models import video_vae as tvv
from chipmunk_torch.models.autoencoder import (AutoEncoderParams,
                                               init_decoder_params)
from chipmunk_torch.utils.safetensors_io import DTYPES, load_file, save_file
from test_torch_encoders import (CLIP_KW, T5_KW, clip_state_dict,
                                 t5_state_dict)
from test_torch_vae import AE_SMALL, HY_KW, hunyuan_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def every_dtype():
    """One tensor of each dtype (random bytes, NaN codes included), a
    scalar and an empty tensor."""
    g = torch.Generator().manual_seed(0)
    out = {}
    for name, dt in DTYPES.items():
        shape = (3, 5) if name != 'F64' else (7,)
        size = torch.empty((), dtype=dt).element_size()
        raw = torch.randint(0, 256, (int(np.prod(shape)) * size,),
                            generator=g, dtype=torch.uint8)
        t = raw.view(dt).reshape(shape) if dt != torch.bool \
            else (raw % 2).view(torch.bool).reshape(shape)
        out[f'x_{name}'] = t
    out['scalar'] = torch.tensor(2.5)
    out['empty'] = torch.zeros((0, 4), dtype=torch.bfloat16)
    return out


def bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.numel():
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


def test_every_dtype_reads_as_the_package_reads_it(tmp_path):
    tensors = every_dtype()
    f = str(tmp_path / 'all.safetensors')
    safetensors.torch.save_file(tensors, f)
    want = safetensors.torch.load_file(f)
    got = load_file(f)
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k in want:
        bits_equal(got[k], want[k])
        bits_equal(got[k], tensors[k])


def test_save_file_is_read_by_safe_open(tmp_path):
    """The port's file, metadata included; tensors given as views and
    non-contiguous slices are written as their values."""
    tensors = every_dtype()
    tensors['view'] = torch.arange(24, dtype=torch.float32).reshape(4, 6).t()
    f = str(tmp_path / 'port.safetensors')
    save_file(tensors, f, metadata={'format': 'pt', 'n': 3})
    with safetensors.safe_open(f, framework='pt') as sf:
        assert sorted(sf.keys()) == sorted(tensors)
        assert sf.metadata() == {'format': 'pt', 'n': '3'}
        for k in tensors:
            bits_equal(sf.get_tensor(k), tensors[k].contiguous())
    n, = struct.unpack('<Q', open(f, 'rb').read(8))
    assert n % 8 == 0
    # a read tensor is the caller's: writing to it leaves the file as it is
    got = load_file(f)
    got['x_F32'].zero_()
    bits_equal(load_file(f)['x_F32'], tensors['x_F32'])


def test_prefixes_and_shard_directories(tmp_path):
    g = torch.Generator().manual_seed(1)
    sd = {f'{p}.{i}.w': torch.randn((2, 3), generator=g)
          for p in ('decoder', 'encoder') for i in range(3)}
    shards = tmp_path / 'shards'
    shards.mkdir()
    keys = sorted(sd)
    save_file({k: sd[k] for k in keys[:4]}, str(shards / 'a.safetensors'))
    safetensors.torch.save_file({k: sd[k] for k in keys[4:]},
                                str(shards / 'b.safetensors'))
    (shards / 'notes.txt').write_text('not a shard')
    got = load_file(str(shards))
    assert sorted(got) == keys
    for k in keys:
        assert torch.equal(got[k], sd[k])
    dec = load_file(str(shards), prefix='decoder.')
    assert sorted(dec) == [k for k in keys if k.startswith('decoder.')]
    one = load_file(str(shards / 'b.safetensors'), prefix='encoder.')
    assert sorted(one) == [k for k in keys[4:] if k.startswith('encoder.')]


def test_refuses_unknown_dtypes_and_broken_files(tmp_path):
    def write(header, data=b''):
        f = tmp_path / 'x.safetensors'
        text = json.dumps(header).encode()
        f.write_bytes(struct.pack('<Q', len(text)) + text + data)
        return str(f)

    with pytest.raises(ValueError, match='F8_E5M2'):
        load_file(write({'a': {'dtype': 'F8_E5M2', 'shape': [2],
                               'data_offsets': [0, 2]}}, b'\0\0'))
    with pytest.raises(ValueError, match='bytes'):
        load_file(write({'a': {'dtype': 'F32', 'shape': [2],
                               'data_offsets': [0, 4]}}, b'\0' * 8))
    with pytest.raises(ValueError, match='bytes'):
        load_file(write({'a': {'dtype': 'F32', 'shape': [4],
                               'data_offsets': [0, 16]}}, b'\0' * 8))
    short = tmp_path / 'short.safetensors'
    short.write_bytes(b'\1\0')
    with pytest.raises(ValueError, match='short'):
        load_file(str(short))
    with pytest.raises(ValueError, match='header'):
        short.write_bytes(struct.pack('<Q', 1 << 40))
        load_file(str(short))
    with pytest.raises(TypeError):
        save_file({'a': np.zeros(2)}, str(tmp_path / 'y.safetensors'))
    with pytest.raises(ValueError, match='dtype'):
        save_file({'a': torch.zeros(2, dtype=torch.complex64)},
                  str(tmp_path / 'y.safetensors'))


def test_load_file_needs_a_gpu_for_cuda(tmp_path, monkeypatch):
    f = str(tmp_path / 'x.safetensors')
    save_file({'a': torch.ones(2)}, f)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        load_file(f, device='cuda')


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def test_loaders_read_without_the_safetensors_package(tmp_path):
    """Files written by save_file, read in a process where importing
    ``safetensors`` fails: T5 (a directory of two shards), CLIP, the FLUX
    AE decoder and the HunyuanVideo VAE give the trees they give here,
    leaf for leaf."""
    rng = np.random.default_rng(2)
    t5 = {k: torch.from_numpy(v) for k, v in t5_state_dict(rng).items()}
    shards = tmp_path / 't5'
    shards.mkdir()
    ks = sorted(t5)
    for name, part in (('a', ks[:len(ks) // 2]), ('b', ks[len(ks) // 2:])):
        save_file({k: t5[k] for k in part},
                  str(shards / f'{name}.safetensors'))
    save_file({k: torch.from_numpy(v) for k, v in
               clip_state_dict(rng, 'text_model.').items()},
              str(tmp_path / 'clip.safetensors'))
    ae = init_decoder_params(torch.Generator().manual_seed(3),
                             AutoEncoderParams(**AE_SMALL), device='cpu')
    flat = {}

    def walk(tree, pre):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f'{pre}.{k}')
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f'{pre}.{i}')
        else:
            flat[pre] = tree + 0.01 * torch.randn(tree.shape)
    walk(ae['decoder'], 'decoder')
    save_file(flat, str(tmp_path / 'ae.safetensors'))
    save_file({k: torch.from_numpy(v) for k, v in hunyuan_state_dict(
        tvv.HyVaeConfig(**HY_KW), rng).items()},
        str(tmp_path / 'vae.safetensors'))
    code = textwrap.dedent(f'''
        import importlib.abc, sys, torch

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split('.')[0] == 'safetensors':
                    raise ImportError('blocked: ' + name)

        sys.meta_path.insert(0, Block())
        from chipmunk_torch.models import flux_encoders as tfe
        from chipmunk_torch.models import loaders as tld
        from chipmunk_torch.models import video_vae as tvv
        d = {str(tmp_path)!r}
        trees = [
            tfe.load_t5_safetensors(d + '/t5', tfe.T5Config(**{T5_KW!r}),
                                    device='cpu'),
            tfe.load_clip_safetensors(d + '/clip.safetensors',
                                      tfe.ClipTextConfig(**{CLIP_KW!r}),
                                      device='cpu'),
            tld.load_ae_decoder_safetensors(d + '/ae.safetensors',
                                            device='cpu'),
            tvv.load_hunyuan_vae_safetensors(
                d + '/vae.safetensors', tvv.HyVaeConfig(**{HY_KW!r}),
                device='cpu')]
        assert 'safetensors' not in sys.modules
        torch.save(trees, d + '/trees.pt')
        ''')
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = torch.load(str(tmp_path / 'trees.pt'), weights_only=False)
    want = [tfe.load_t5_safetensors(str(shards), tfe.T5Config(**T5_KW),
                                    device='cpu'),
            tfe.load_clip_safetensors(str(tmp_path / 'clip.safetensors'),
                                      tfe.ClipTextConfig(**CLIP_KW),
                                      device='cpu'),
            tld.load_ae_decoder_safetensors(str(tmp_path / 'ae.safetensors'),
                                            device='cpu'),
            tvv.load_hunyuan_vae_safetensors(
                str(tmp_path / 'vae.safetensors'), tvv.HyVaeConfig(**HY_KW),
                device='cpu')]
    for g, w in zip(got, want):
        gl, wl = leaves(g), leaves(w)
        assert len(gl) == len(wl) > 4
        for a, b in zip(gl, wl):
            assert torch.equal(a, b)
