"""FLUX image generation as the benchmark drives it: the program's
``cli.flux_generate.generate`` (the CLI's host loop) from noise and text
embeddings drawn on the card, then ``models.decode`` with the FLUX
autoencoder's decoder on ``models.unpack`` of the latent; and the check
of one generation against the plain reference.

Weights of the transformer and of the decoder are drawn from the run's
seed on the device in the served dtype (``core.weights``), in the
program's parameter layout; text embeddings stand in for T5 and CLIP.
Under ``mlp.is_fp8`` the MLP weights are stored as the program's loader
stores them (``modules.mlp_fp8.quant_spec_for_is_fp8``).

While a generation runs, the program's calls of one double block and
one single block (drawn from the seed), of the input embedding and of
the final layer are wrapped: at every computed step their inputs, the
chipmunk state they start from (the rows of one MLP token block, also
drawn from the seed) and their outputs are copied to the host
(``core.record``).  The check computes each recorded block at each step
again from those inputs and that state (``reference.flux.FluxRef``) and
compares its output, and the state it writes with the state the program
starts the next computed step from.
"""
from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import torch

from benchmarks.core import weights as W
from benchmarks.core.record import Recorder
from benchmarks.reference import flux as ref_flux
from benchmarks.reference import flux_ae as ref_ae


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def merged(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def transformer_spec(m: Dict) -> List[W.Leaf]:
    """The program's FLUX parameter tree: linear weights [d_in, d_out]
    ~ N(0, 1/d_in), MLP weights output-major [N, C] ~ N(0, 1/d_in),
    biases ~ N(0, 0.02^2), norm scales ~ 1 + N(0, 0.05^2)."""
    h, hd = m['hidden_size'], m['hidden_size'] // m['num_heads']
    n = int(h * m['mlp_ratio'])
    spec: List[W.Leaf] = []
    bias, norm = 0.02, 0.05

    def lin(path, d_in, d_out, b=True):
        spec.append((path + ('w',), (d_in, d_out), 0.0, d_in ** -0.5))
        if b:
            spec.append((path + ('b',), (d_out,), 0.0, bias))

    def emb(path, d_in):
        lin(path + ('in',), d_in, h)
        lin(path + ('out',), h, h)

    lin(('img_in',), m['in_channels'], h)
    lin(('txt_in',), m['context_in_dim'], h)
    emb(('time_in',), 256)
    emb(('vector_in',), m['vec_in_dim'])
    if m.get('guidance_embed', True):
        emb(('guidance_in',), 256)
    for i in range(m['depth']):
        p = ('double', i)
        for s in ('img', 'txt'):
            lin(p + (f'{s}_mod',), h, 6 * h)
            lin(p + (f'{s}_qkv',), h, 3 * h, m.get('qkv_bias', True))
            lin(p + (f'{s}_proj',), h, h)
            for nm in ('qnorm', 'knorm'):
                spec.append((p + (f'{s}_{nm}',), (hd,), 1.0, norm))
            spec.append((p + (f'{s}_w1t',), (n, h), 0.0, h ** -0.5))
            spec.append((p + (f'{s}_b1',), (n,), 0.0, bias))
            spec.append((p + (f'{s}_w2',), (n, h), 0.0, n ** -0.5))
            spec.append((p + (f'{s}_b2',), (h,), 0.0, bias))
    for i in range(m['depth_single_blocks']):
        p = ('single', i)
        lin(p + ('mod',), h, 3 * h)
        lin(p + ('qkv',), h, 3 * h)
        spec.append((p + ('w1t',), (n, h), 0.0, h ** -0.5))
        spec.append((p + ('b1',), (n,), 0.0, bias))
        lin(p + ('o_proj',), h, h)
        spec.append((p + ('w2',), (n, h), 0.0, n ** -0.5))
        for nm in ('qnorm', 'knorm'):
            spec.append((p + (nm,), (hd,), 1.0, norm))
    lin(('final_mod',), h, 2 * h)
    lin(('final_proj',), h, m['in_channels'])
    return spec


def decoder_spec(a: Dict) -> List[W.Leaf]:
    """BFL's AutoEncoder decoder in the ``decoder.*`` layout: convolutions
    OIHW ~ N(0, 0.02^2), biases ~ N(0, 0.02^2), norms ~ 1 + N(0, 0.05^2)."""
    spec: List[W.Leaf] = []
    ch, mult, nres = a['ch'], a['ch_mult'], a['num_res_blocks']

    def conv(path, cin, cout, k=3):
        spec.append((path + ('weight',), (cout, cin, k, k), 0.0, 0.02))
        spec.append((path + ('bias',), (cout,), 0.0, 0.02))

    def gn(path, c):
        spec.append((path + ('weight',), (c,), 1.0, 0.05))
        spec.append((path + ('bias',), (c,), 0.0, 0.02))

    def res(path, cin, cout):
        gn(path + ('norm1',), cin)
        conv(path + ('conv1',), cin, cout)
        gn(path + ('norm2',), cout)
        conv(path + ('conv2',), cout, cout)
        if cin != cout:
            conv(path + ('nin_shortcut',), cin, cout, 1)

    d = ('decoder',)
    cur = ch * mult[-1]
    conv(d + ('conv_in',), a['z_channels'], cur)
    res(d + ('mid', 'block_1'), cur, cur)
    gn(d + ('mid', 'attn_1', 'norm'), cur)
    for nm in ('q', 'k', 'v', 'proj_out'):
        conv(d + ('mid', 'attn_1', nm), cur, cur, 1)
    res(d + ('mid', 'block_2'), cur, cur)
    for i in reversed(range(len(mult))):
        cout = ch * mult[i]
        for j in range(nres + 1):
            res(d + ('up', i, 'block', j), cur, cout)
            cur = cout
        if i > 0:
            conv(d + ('up', i, 'upsample', 'conv'), cur, cur)
    gn(d + ('norm_out',), cur)
    conv(d + ('conv_out',), cur, 3)
    return spec


def _seed(seed: int, *salt: int) -> int:
    """A generator seed from the run's seed and a salt, below 2**63."""
    x = seed & ((1 << 64) - 1)
    for s in salt:
        x = (x * 6364136223846793005 + 1442695040888963407 + s) & \
            ((1 << 64) - 1)
    return x >> 1


WARM = 1 << 20        # the input index of the set-up's generation


class Cell:
    """One FLUX cell: ``config`` the configuration file, ``traffic`` the
    mix (its ``chipmunk`` settings merged onto the configuration's)."""

    def __init__(self, config: Dict, traffic: Dict, device: torch.device,
                 seed: int):
        self.cfg, self.traffic, self.dev, self.seed = config, traffic, \
            device, seed
        self.m = m = config['model']
        self.ck = merged(config['chipmunk'], traffic.get('chipmunk', {}))
        self.width, self.height = config['width'], config['height']
        self.steps, self.guidance = config['steps'], config['guidance']
        self.batch = traffic.get('batch', 1)
        if self.batch != 1:
            raise ValueError('the FLUX check records batch 1')
        self.dtype = torch.bfloat16 if device.type == 'cuda' else \
            torch.float32
        self.kept = None              # (index, steps, latent, pixels, items)
        self._seen, self._rng = 0, random.Random(seed)
        self._live = self._steps = None
        self._recording, self._orig = False, {}
        # the recorded blocks and rows, drawn from the seed
        pick = random.Random(_seed(seed, 5))
        nd = max(self.ck.get('attn', {}).get('first_n_dense_layers', 2),
                 self.ck.get('mlp', {}).get('first_n_dense_layers', 2))
        self.dbl = pick.randrange(min(nd, m['depth'] - 1), m['depth'])
        self.sgl = pick.randrange(m['depth_single_blocks'])
        self.bm = self.ck.get('mlp', {}).get('bm', 128)
        self.mbm = self.ck.get('mlp', {}).get('mbm', 128)
        self.qg = self.ck.get('attn', {}).get('mbm', 128)
        nt, s_img = m['txt_len'], (self.height // 16) * (self.width // 16)
        self.tb_d = pick.randrange(-(-s_img // self.bm))
        self.tb_s = pick.randrange(-(-(nt + s_img) // self.bm))
        self.rows_d = slice(self.tb_d * self.bm,
                            min((self.tb_d + 1) * self.bm, s_img))
        self.rows_s = slice(self.tb_s * self.bm,
                            min((self.tb_s + 1) * self.bm, nt + s_img))
        # the computed steps recorded: all of them, or where no state
        # carries from step to step the traffic's ``record_steps`` of them
        computed = self._computed(self.steps)
        n = traffic.get('record_steps')
        self.rec_steps = set(computed) if n is None else \
            set(pick.sample(computed, min(n, len(computed))))
        for v in (nt, self.rows_d.start, self.rows_d.stop,
                  self.rows_s.start, self.rows_s.stop):
            if v % self.qg:
                raise ValueError('recorded rows must be whole query groups')

    # ------------------------------------------------------------ program
    def _program_config(self, ck: Dict):
        from chipmunk_torch.config import config_from_dict
        from chipmunk_torch.models import FluxModelConfig
        m = self.m
        model = FluxModelConfig(
            in_channels=m['in_channels'], vec_in_dim=m['vec_in_dim'],
            context_in_dim=m['context_in_dim'],
            hidden_size=m['hidden_size'], num_heads=m['num_heads'],
            mlp_ratio=m['mlp_ratio'], depth=m['depth'],
            depth_single_blocks=m['depth_single_blocks'],
            axes_dim=tuple(m['axes_dim']), theta=m['theta'],
            qkv_bias=m.get('qkv_bias', True),
            guidance_embed=m.get('guidance_embed', True),
            txt_len=m['txt_len'], dtype=self.dtype)
        return model, config_from_dict(ck).replace(steps=self.steps)

    def _weights(self):
        return (W.draw(transformer_spec(self.m), _seed(self.seed, 1),
                       self.dtype, self.dev),
                W.draw(decoder_spec(self.cfg['autoencoder']),
                       _seed(self.seed, 2), torch.float32, self.dev))

    def inputs(self, i: int):
        """Generation ``i``'s noise (bf16-rounded like the CLI's), text
        embeddings, pooled vector and keep seed, drawn on the device."""
        g = torch.Generator(self.dev).manual_seed(_seed(self.seed, 3, i))
        m, B = self.m, self.batch
        s_img = (self.height // 16) * (self.width // 16)
        img = torch.randn((B, s_img, m['in_channels']), generator=g,
                          device=self.dev).to(self.dtype)
        txt = torch.randn((B, m['txt_len'], m['context_in_dim']),
                          generator=g, device=self.dev).to(self.dtype)
        y = torch.randn((B, m['vec_in_dim']), generator=g,
                        device=self.dev).to(self.dtype)
        return img, txt, y, _seed(self.seed, 4, i)

    def setup(self) -> None:
        """Weights (the MLP's stored as ``mlp.is_fp8`` says), the
        recorder, and a generation of the traffic's ``warm_steps`` steps
        at full size (every step kind of the cell, the allocator's pool,
        the recorder's host slabs) and its decode."""
        from chipmunk_torch.models import AutoEncoderParams
        self.model, self.pck = self._program_config(self.ck)
        self.params, self.ae = self._weights()
        if self.ck.get('mlp', {}).get('is_fp8'):
            from chipmunk_torch.modules.mlp_fp8 import quant_spec_for_is_fp8
            from chipmunk_torch.utils.quant import quantize_flux_params
            self.params = quantize_flux_params(self.params,
                                               quant_spec_for_is_fp8())
        a = self.cfg['autoencoder']
        self.acfg = AutoEncoderParams(ch=a['ch'], ch_mult=tuple(a['ch_mult']),
                                      num_res_blocks=a['num_res_blocks'],
                                      z_channels=a['z_channels'])
        self.rec = Recorder(self.dev)
        self._wrap()
        self._warm()

    def _computed(self, steps: int) -> List[int]:
        return [s for s, k in enumerate(ref_flux.step_kinds(self.ck, steps))
                if not k['skip']]

    def _warm(self) -> None:
        n = self.traffic.get('warm_steps', self.steps)
        pck, rec_steps = self.pck, self.rec_steps
        self.pck, self.rec_steps = pck.replace(steps=n), set(range(n))
        try:
            self.generation(WARM, keep=False)
        finally:
            self.pck, self.rec_steps = pck, rec_steps
        per_step = self.rec.used() / len(self._computed(n))
        self.rec.reserve(int(per_step * len(rec_steps) * 1.05) + (1 << 20))

    def _wrap(self) -> None:
        """Wrap, while the cell runs, the sampler's ``flux_forward`` (the
        latent entering each computed step and its prediction, kept
        without a copy) and the model's input embedding, final layer and
        blocks (``core.record``)."""
        from chipmunk_torch.models import flux, sampling
        self._orig = {(sampling, 'flux_forward'): sampling.flux_forward,
                      (flux, 'flux_embed'): flux.flux_embed,
                      (flux, 'flux_final'): flux.flux_final,
                      (flux, 'double_block'): flux.double_block,
                      (flux, 'single_block'): flux.single_block,
                      (flux, '_attn_call'): flux._attn_call,
                      (flux, '_mlp_call'): flux._mlp_call}
        f_fwd, f_embed, f_final, f_double, f_single, f_attn, f_mlp = \
            self._orig.values()
        cell = self
        cell._cur = None       # (key, attention rows, MLP rows) in a block

        def forward(*a, **k):
            step = a[9] if len(a) > 9 else k['step']
            cell._step = step.index
            cell._live = cell.rec if cell._recording and \
                step.index in cell.rec_steps else None
            pred, state = f_fwd(*a, **k)
            if cell._steps is not None:
                img = a[3] if len(a) > 3 else k['img']
                cell._steps.append((step.index, img, pred))
            return pred, state

        def embed(params, cfg, img, txt, *a, **k):
            out = f_embed(params, cfg, img, txt, *a, **k)
            r = cell._live
            if r is not None:
                r.put(('embed', cell._step, 'img'), out[0][:, cell.rows_d])
                r.put(('embed', cell._step, 'txt'), out[1])
            return out

        def final(params, cfg, x, vec, n_txt=None):
            out = f_final(params, cfg, x, vec, n_txt)
            r = cell._live
            if r is not None:
                nt = cfg.txt_len if n_txt is None else n_txt
                rows = slice(nt + cell.rows_d.start, nt + cell.rows_d.stop)
                r.put(('final', cell._step, 'x'), x[:, rows])
            return out

        def double(cfg, sp, p, img, txt, vec, cos, sin, ast, mst, idx,
                   step, generator=None):
            r = cell._live
            if r is None or idx != cell.dbl:
                return f_double(cfg, sp, p, img, txt, vec, cos, sin, ast,
                                mst, idx, step, generator)
            k, nt, rows = ('double', step.index), txt.shape[1], cell.rows_d
            cell._put_mlp(r, k, mst, cell.tb_d)
            r.fence()         # the sparse MLP step writes its caches in place
            r.put(k + ('img',), img)
            r.put(k + ('txt',), txt)
            parts = [slice(0, nt), slice(nt + rows.start, nt + rows.stop)]
            cell._put_attn(r, k, ast, parts)
            cell._cur = (k, parts, rows)
            try:
                out = f_double(cfg, sp, p, img, txt, vec, cos, sin, ast,
                               mst, idx, step, generator)
            finally:
                cell._cur = None
            r.put(k + ('img_out',), out[0][:, rows])
            r.put(k + ('txt_out',), out[1])
            cell._put_sel(r, k, out[2], out[3], cell.tb_d)
            return out

        def single(cfg, sp, p, x, vec, cos, sin, ast, mst, idx, step,
                   generator=None):
            r = cell._live
            if r is None or idx != cell.sgl:
                return f_single(cfg, sp, p, x, vec, cos, sin, ast, mst, idx,
                                step, generator)
            k = ('single', step.index)
            cell._put_mlp(r, k, mst, cell.tb_s)
            r.fence()
            r.put(k + ('x',), x)
            cell._put_attn(r, k, ast, [cell.rows_s])
            cell._cur = (k, [cell.rows_s], cell.rows_s)
            try:
                out = f_single(cfg, sp, p, x, vec, cos, sin, ast, mst, idx,
                               step, generator)
            finally:
                cell._cur = None
            r.put(k + ('x_out',), out[0][:, cell.rows_s])
            cell._put_sel(r, k, out[1], out[2], cell.tb_s)
            return out

        def attn(mod, q, k, v, st, step, is_dense, generator, *a, **kw):
            out = f_attn(mod, q, k, v, st, step, is_dense, generator, *a,
                         **kw)
            if cell._cur is not None:
                key, parts, _ = cell._cur
                for j, rows in enumerate(parts):
                    cell._live.put(key + ('attn_o', j), out[0][:, :, rows])
            return out

        def mlp(mod, x2d, *a, **kw):
            if cell._cur is None:
                return f_mlp(mod, x2d, *a, **kw)
            key, _, rows = cell._cur
            cell._live.put(key + ('mlp_x',), x2d[rows])
            out = f_mlp(mod, x2d, *a, **kw)
            cell._live.put(key + ('mlp_y',), out[0][rows])
            return out

        for (mod, name), f in zip(self._orig, (forward, embed, final, double,
                                               single, attn, mlp)):
            setattr(mod, name, f)

    def _put_mlp(self, r, k, st, tb) -> None:
        if st is None:
            return
        rows = slice(tb * self.bm, (tb + 1) * self.bm)
        mids = slice(tb * self.bm // self.mbm, (tb + 1) * self.bm // self.mbm)
        r.put(k + ('mlp_out',), st.out_cache[rows])
        r.put(k + ('mlp_act',), st.act_cache[rows])
        r.put(k + ('mlp_mid',), st.bm_mid[mids])
        r.put(k + ('mlp_inds',), st.inds[tb:tb + 1])
        r.put(k + ('mlp_counts',), st.counts[tb:tb + 1])

    def _put_attn(self, r, k, st, parts) -> None:
        if st is None:
            return
        for j, rows in enumerate(parts):
            r.put(k + ('attn_cache', j), st.out_cache[:, :, rows])
            r.put(k + ('attn_lse', j), st.lse[:, :, rows])
        r.put(k + ('attn_inds',), st.inds)
        r.put(k + ('attn_counts',), st.counts)

    def _put_sel(self, r, k, ast, mst, tb) -> None:
        """The selections the step ends with (the ones it made)."""
        if ast is not None:
            r.put(k + ('attn_inds_after',), ast.inds)
            r.put(k + ('attn_counts_after',), ast.counts)
        if mst is not None:
            r.put(k + ('mlp_inds_after',), mst.inds[tb:tb + 1])
            r.put(k + ('mlp_counts_after',), mst.counts[tb:tb + 1])

    def generation(self, i: int, keep: bool = True) -> Dict[str, float]:
        """One image: denoise then decode, each span synchronised.  Of the
        generations kept, one drawn uniformly from the seed (a reservoir
        of one) keeps its steps, latent, pixels and record for the check;
        each generation records into the host slab the kept one does not
        hold, except one that is neither kept nor set-up's (the traced
        one: its trace shows the program alone)."""
        from chipmunk_torch.cli.flux_generate import generate
        from chipmunk_torch.models import decode, unpack
        img, txt, y, kseed = self.inputs(i)
        slab = 1 if self.kept is not None and self._kept_slab == 0 else 0
        items = self.rec.start(slab)
        self._steps, self._recording = [], keep or i == WARM
        t0 = time.perf_counter()
        try:
            lat = generate(self.params, self.model, self.pck,
                           width=self.width, height=self.height,
                           guidance=self.guidance, seed=kseed,
                           batch=self.batch, txt=txt, y=y, img=img,
                           loop='host', device=self.dev)
            _sync(self.dev)
        finally:
            self._live, self._recording = None, False
        t1 = time.perf_counter()
        pix = decode(self.ae, unpack(lat.float(), self.height, self.width),
                     self.acfg)
        _sync(self.dev)
        t2 = time.perf_counter()
        steps, self._steps = self._steps, None
        if keep:
            self._seen += 1
            if self._rng.random() * self._seen < 1.0:
                self.kept, self._kept_slab = (i, steps, lat, pix, items), slab
        return {'denoise': t1 - t0, 'decode': t2 - t1}

    def release(self) -> None:
        """Drop the program's weights and state; unwrap the model."""
        for (mod, name), f in self._orig.items():
            setattr(mod, name, f)
        self._orig = {}
        self.params = self.ae = None
        gc.collect()
        if self.dev.type == 'cuda':
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- check
    def euler(self, dtype=torch.float32) -> Dict[int, torch.Tensor]:
        """The Euler rule applied to the program's own latents and
        predictions: {step: the latent the next computed step should
        receive}, skipped steps reusing the prediction, the last one in
        raster order; ``dtype`` the latent's (bfloat16: the control of
        ``euler_err``)."""
        rec = self.kept[1]
        ts = ref_flux.timesteps(self.steps,
                                (self.height // 16) * (self.width // 16))
        out = {}
        for n, (step, x, pred) in enumerate(rec):
            end = rec[n + 1][0] if n + 1 < len(rec) else self.steps
            x = x.to(dtype)
            for j in range(step, end):
                x = (x.float() + (ts[j + 1] - ts[j]) * pred.float()).to(dtype)
            out[step] = x.float()
        last = rec[-1][0]
        h, w = self.height // 16, self.width // 16
        perm = _perm(self.ck, h, w, self.dev)
        out[last] = torch.empty_like(out[last]).index_copy_(1, perm,
                                                            out[last])
        return out

    def decode_in(self, dtype: torch.dtype) -> torch.Tensor:
        """The program's decode of the kept latent with the decoder's
        weights, drawn again from the seed, in ``dtype`` (bfloat16: the
        control of ``pixel_err``)."""
        from chipmunk_torch.models import decode, unpack
        _, ae = self._weights()
        ae = {'decoder': _cast(ae['decoder'], dtype)}
        lat = self.kept[2]
        return decode(ae, unpack(lat.float(), self.height, self.width),
                      self.acfg).float()

    def _ref_params(self, params: Dict) -> Dict:
        """The leaves the check reads, copied out of the drawn buffer."""
        p = {k: _cast(v, None) for k, v in params.items()
             if k not in ('double', 'single')}
        p['double'] = {self.dbl: _cast(params['double'][self.dbl], None)}
        p['single'] = {self.sgl: _cast(params['single'][self.sgl], None)}
        return p

    def check(self, low: bool = False):
        """The compared numbers of the kept generation (the worst over its
        recorded steps; each a relative L2 gap unless said otherwise),
        every recorded block computed again from the program's inputs
        and the state it started the step from:

        - ``block_err``: a recorded block's update of each stream (output
          minus input; the recorded rows and every text row), the input
          embedding and the final layer;
        - ``attn_err``: the attention's output (the recorded query rows),
          from the block's input, with the attention state that the
          reference itself wrote at the full steps before (so the caches'
          writes are judged by the sparse steps that read them);
        - ``mlp_err``: the MLP's output (one token block), from the
          program's own MLP input and state;
        - ``mlp_flip``: the share of the entries of the MLP's fp8 caches
          (activations, output) that a step writes, from the program's own
          MLP input and state, which the program rounds to another fp8
          value than the reference, read where the program starts the
          next recorded step (so a write that is missing or carried wrong
          shows); ``cache_err`` / ``cache_flip``: the relative gap and the
          flipped share of every cache and sum written (attention's from
          the block's input too), which no control separates (PERF.md);
        - ``sel_regret``: the share of the top-k score that the program's
          selections (attention at column-sum steps, MLP at re-selecting
          steps) miss under the reference's scores;
        - ``euler_err``: each computed step's next latent against the
          Euler rule on the program's own latent and prediction (skipped
          steps, the final reorder);
        - ``pixel_err``: the pixels against the reference's decode of the
          final latent.

        A computed step missing
        from the program's, one it computed that the schedule skips, or a
        missing record gives no number (read as infinite).  ``low``: also
        the same numbers of the reference computed from e4m3 operands
        against the float32 one (``FluxRef`` fmt 'fp8'), returned second.
        """
        if self.kept is None:          # no generation was kept
            return ({}, {}) if low else {}
        i, rec, lat, pix, items = self.kept
        steps = [r[0] for r in rec]
        if steps != self._computed(self.steps):
            return ({}, {}) if low else {}
        self.rec.sync()
        params, ae = self._weights()
        p = self._ref_params(params)
        del params
        gc.collect()
        _, txt, y, _ = self.inputs(i)
        with torch.no_grad(), ref_flux.fp32_matmuls():
            got, got8 = self._follow(rec, items, p, txt, y, low)
            del p
            a = self.cfg['autoencoder']
            rpix = ref_ae.decode(ae, ref_flux.unpack(lat, self.height,
                                                     self.width),
                                 levels=len(a['ch_mult']),
                                 blocks=a['num_res_blocks'] + 1)
        if got:
            nxt = {s: x for s, x in
                   zip(steps, [r[1] for r in rec[1:]] + [lat])}
            got['euler_err'] = max(rel(nxt[s], x)
                                   for s, x in self.euler().items())
            got['pixel_err'] = rel(pix, rpix)
        return (got, got8) if low else got

    def _follow(self, rec, items, p, txt, y, low: bool):
        m, ck, dev = self.m, self.ck, self.dev
        h, w = self.height // 16, self.width // 16
        refs = {'f32': ref_flux.FluxRef(m, ck, p, h, w)}
        if low:
            refs['fp8'] = ref_flux.FluxRef(m, ck, p, h, w, fmt='fp8')
        cos, sin = refs['f32'].pe(1, dev)
        ts = ref_flux.timesteps(self.steps, h * w)
        kinds = ref_flux.step_kinds(ck, self.steps)
        txt = txt.float()
        N = int(m['hidden_size'] * m['mlp_ratio'])
        nt, S = m['txt_len'], m['txt_len'] + h * w
        qg = self.qg
        blocks = [('double', self.dbl, m['depth'] > 0, self.rows_d,
                   torch.cat([torch.arange(nt // qg),
                              torch.arange((nt + self.rows_d.start) // qg,
                                           (nt + self.rows_d.stop) // qg)
                              ]).to(dev)),
                  ('single', self.sgl, True, self.rows_s,
                   torch.arange(self.rows_s.start // qg,
                                self.rows_s.stop // qg).to(dev))]
        layer = {'double': self.dbl, 'single': m['depth'] + self.sgl}
        sels = {r: ref_flux.Selections() for r in refs}
        mods = {(r, name, part): (
            ref_flux.AttnRef(ck.get('attn', {}), S, layer[name], sels[r])
            if part.startswith('attn') else
            ref_flux.MlpRef(ck.get('mlp', {}), self.bm, N, layer[name],
                            sels[r]))
            for r in refs for name, *_ in blocks
            for part in ('attn', 'attn_own', 'mlp', 'mlp_solo')}
        gaps = {r: {} for r in refs}
        written = {}                 # what the reference wrote, by block
        gen = torch.Generator(dev).manual_seed(0)   # own keeps: never taken

        def get(*key):
            t = Recorder.get(items, key, dev)
            if t is None:
                raise KeyError(key)
            return t

        def note(r, name, value):
            gaps[r].setdefault(name, []).append(value)

        def cache(r, prog, refv, mlp):
            note(r, 'cache_err', rel(prog.float(), refv.float()))
            if prog.dtype == ref_flux.FP8 and refv.dtype == ref_flux.FP8:
                f = float((prog.view(torch.uint8) != refv.view(torch.uint8))
                          .double().mean())
                note(r, 'cache_flip', f)
                if mlp:
                    note(r, 'mlp_flip', f)

        try:
            for n, s in enumerate(x[0] for x in rec):
                if s not in self.rec_steps:
                    continue
                kind = dict(kinds[s], step=s)
                outs = {}
                for r, ref in refs.items():
                    vec = ref.vec(ts[s], self.guidance, y)
                    ei, et = ref.embed(rec[n][1][:, self.rows_d].float(), txt)
                    outs[r] = {('embed', 'img'): ei, ('embed', 'txt'): et,
                               ('final',): ref.final(get('final', s, 'x'),
                                                     vec)}
                    outs[r]['vec'] = vec
                prog = {('embed', 'img'): get('embed', s, 'img'),
                        ('embed', 'txt'): get('embed', s, 'txt'),
                        ('final',): rec[n][2][:, self.rows_d]}
                for key in prog:
                    note('f32', 'block_err', rel(prog[key], outs['f32'][key]))
                    if low:
                        note('fp8', 'block_err', rel(outs['fp8'][key],
                                                     outs['f32'][key]))
                for name, idx, _, rows, groups in blocks:
                    k = (name, s)
                    L = layer[name]
                    dense_a, dense_m = L < ck.get('attn', {}).get(
                        'first_n_dense_layers', 2), L < ck.get('mlp', {}).get(
                        'first_n_dense_layers', 2)
                    st = {}
                    if mods[('f32', name, 'attn')].stateful(dense_a):
                        nparts = 2 if name == 'double' else 1
                        st['attn'] = (
                            torch.cat([get(*k, 'attn_cache', j)
                                       for j in range(nparts)], 2),
                            torch.cat([get(*k, 'attn_lse', j)
                                       for j in range(nparts)], 2),
                            get(*k, 'attn_inds')[:, :, groups],
                            get(*k, 'attn_counts')[:, :, groups])
                        for r in refs:
                            sels[r].given[(s, 'attn', L)] = (
                                get(*k, 'attn_inds_after')[:, :, groups],
                                get(*k, 'attn_counts_after')[:, :, groups])
                    if mods[('f32', name, 'mlp')].stateful(dense_m):
                        st['mlp'] = (get(*k, 'mlp_out'), get(*k, 'mlp_act'),
                                     get(*k, 'mlp_mid').float(),
                                     get(*k, 'mlp_inds'),
                                     get(*k, 'mlp_counts'))
                        for r in refs:
                            sels[r].given[(s, 'mlp', L)] = (
                                get(*k, 'mlp_inds_after'),
                                get(*k, 'mlp_counts_after'))
                    # the program's state at this step against what the
                    # reference wrote from its state at the step before
                    for part, new in written.pop(name, {}).items():
                        for pv, rv in zip(st[part], new):
                            cache('f32', pv, rv, part == 'mlp')
                    for r, ref in refs.items():
                        am, ao, mm_, ms = (mods[(r, name, x)] for x in
                                           ('attn', 'attn_own', 'mlp',
                                            'mlp_solo'))
                        if 'attn' in st:
                            am.cache, am.lse, am.ids, am.counts = st['attn']
                        if 'mlp' in st:
                            for mod in (mm_, ms):
                                (mod.out, mod.act, mod.bm_mid, mod.ids,
                                 mod.counts) = st['mlp']
                        vec = outs[r]['vec']
                        if name == 'double':
                            outs[r][(name, 'img')], outs[r][(name, 'txt')] = \
                                ref.double(idx, get(*k, 'img'),
                                           get(*k, 'txt'), vec, cos, sin,
                                           kind, rows, am, mm_, gen, ao)
                        else:
                            outs[r][(name, 'x')] = ref.single(
                                idx, get(*k, 'x'), vec, cos, sin, kind, rows,
                                am, mm_, gen, ao)
                        outs[r][(name, 'attn_o')] = ref.last_own
                        outs[r][(name, 'mlp_y')] = ref.mlp(
                            name, idx, get(*k, 'mlp_x'), kind, ms, gen)
                        outs[r][(name, 'written')] = {}
                        if 'attn' in st:
                            outs[r][(name, 'written')]['attn'] = (am.cache,
                                                                  am.lse)
                        if 'mlp' in st:
                            outs[r][(name, 'written')]['mlp'] = (
                                ms.out, ms.act, ms.bm_mid)
                    # the block's update of each stream, its attention and
                    # its MLP
                    if name == 'double':
                        ins = {(name, 'img'): get(*k, 'img')[:, rows],
                               (name, 'txt'): get(*k, 'txt')}
                        res = {(name, 'img'): get(*k, 'img_out'),
                               (name, 'txt'): get(*k, 'txt_out')}
                    else:
                        ins = {(name, 'x'): get(*k, 'x')[:, rows]}
                        res = {(name, 'x'): get(*k, 'x_out')}
                    nparts = 2 if name == 'double' else 1
                    res[(name, 'attn_o')] = torch.cat(
                        [get(*k, 'attn_o', j) for j in range(nparts)], 2)
                    res[(name, 'mlp_y')] = get(*k, 'mlp_y')
                    for key, pv in res.items():
                        what = {'attn_o': 'attn_err', 'mlp_y': 'mlp_err'}.get(
                            key[1], 'block_err')
                        i0 = ins[key].double() if key in ins else 0.0
                        note('f32', what, rel(pv.double() - i0,
                                              outs['f32'][key].double() - i0))
                        if low:
                            note('fp8', what, rel(
                                outs['fp8'][key].double() - i0,
                                outs['f32'][key].double() - i0))
                    if low:
                        for part, new in outs['fp8'][(name, 'written')] \
                                .items():
                            for pv, rv in zip(
                                    new, outs['f32'][(name, 'written')][part]):
                                cache('fp8', pv, rv, part == 'mlp')
                    written[name] = outs['f32'][(name, 'written')]
        except KeyError:
            return {}, {}
        res = []
        for r in refs:
            got = {k: max(v) for k, v in gaps[r].items()}
            if sels[r].regret:
                got['sel_regret'] = max(sels[r].regret)
            res.append(got)
        return res[0], (res[1] if low else {})


def _perm(ck: Dict, h: int, w: int, dev) -> torch.Tensor:
    pc = ck.get('patchify', {})
    if not pc.get('is_enabled', True):
        return torch.arange(h * w, device=dev)
    return torch.from_numpy(ref_flux.patch_order(
        h, w, pc.get('chunk_size_1', 8), pc.get('chunk_size_2', 4))
    ).long().to(dev)


def _cast(tree, dtype):
    """A copy of a tree of tensors, in ``dtype`` (None: their own)."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.clone() if dtype is None else tree.to(dtype)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64; inf where either is not finite."""
    a, b = a.double(), b.double()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        return float('inf')
    return float((a - b).norm() / b.norm().clamp(min=1e-30))
