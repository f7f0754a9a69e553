"""chipmunk_torch config, YAML reader, schedules and token reorder against
chipmunk_tpu and pyyaml, on every shipped config."""
import dataclasses
import glob
import os

import numpy as np
import pytest
import yaml

import chipmunk_tpu.config as jconfig
import chipmunk_tpu.schedule as jschedule
from chipmunk_tpu.ops.patch import inverse_patch_order as j_inverse
from chipmunk_tpu.ops.patch import patch_order as j_patch_order
from chipmunk_torch import config, schedule
from chipmunk_torch.ops.patch import inverse_patch_order, patch_order

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), '..',
                                        'configs', '*.yml')))


def test_all_three_configs_are_covered():
    assert [os.path.basename(p) for p in CONFIGS] == [
        'flux-chipmunk.yml', 'hunyuan-chipmunk.yml', 'wan-chipmunk.yml']


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_yaml_reader_matches_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_load_config_matches_reference(path):
    assert dataclasses.asdict(config.load_config(path)) == \
        dataclasses.asdict(jconfig.load_config(path))


def test_yaml_reader_scalars_and_errors():
    text = ('a:\n  x: ~\n  y: false\n  z: -3\n  w: 1.5e-3\n  s: "q # r"\n'
            '  l: [1, 2.5, on]\nb: plain text  # comment\n')
    assert config.parse_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError):
        config.parse_yaml('a: 1\nnot a mapping\n')


def test_config_from_dict_matches_reference():
    d = {'steps': 12, 'attn': {'top_keys': 0.4, 'full_step_schedule': [0, 3]},
         'mlp': {'bm': 512}, 'offloading': {'attn.out_cache': False},
         'step_caching': {'skip_step_schedule': {2, 5}}}
    assert dataclasses.asdict(config.config_from_dict(d)) == \
        dataclasses.asdict(jconfig.config_from_dict(d))
    with pytest.raises(KeyError):
        config.config_from_dict({'mlp': {'no_such_key': 1}})


@pytest.mark.parametrize('path', CONFIGS, ids=os.path.basename)
def test_step_plan_and_fold_match_reference(path):
    ck, jck = config.load_config(path), jconfig.load_config(path)
    plan, jplan = schedule.step_plan(ck), jschedule.step_plan(jck)
    assert [dataclasses.asdict(k) for k in plan] == \
        [dataclasses.asdict(k) for k in jplan]
    ts = np.linspace(1, 0, ck.steps + 1)
    assert schedule.fold_skip_steps(plan, ts, ck.steps) == \
        jschedule.fold_skip_steps(jplan, ts, jck.steps)


@pytest.mark.parametrize('h,w,c1,c2', [(48, 80, 8, 4), (16, 24, 4, 2),
                                       (8, 8, 8, 8)])
def test_patch_order_matches_reference(h, w, c1, c2):
    np.testing.assert_array_equal(patch_order(h, w, c1, c2),
                                  j_patch_order(h, w, c1, c2))
    np.testing.assert_array_equal(inverse_patch_order(h, w, c1, c2),
                                  j_inverse(h, w, c1, c2))


@pytest.mark.parametrize('path', CONFIGS)
def test_global_config_matches_reference(path, monkeypatch):
    """load_from_file merges a file onto GLOBAL_CONFIG as the reference's
    does (twice: the second merge is onto the first's result), and
    set_global_config replaces it."""
    monkeypatch.setattr(config, 'GLOBAL_CONFIG', config.ChipmunkConfig())
    monkeypatch.setattr(jconfig, 'GLOBAL_CONFIG', jconfig.ChipmunkConfig())
    for _ in range(2):
        got, ref = config.load_from_file(path), jconfig.load_from_file(path)
        assert got is config.GLOBAL_CONFIG
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    config.set_global_config(config.ChipmunkConfig())
    assert config.GLOBAL_CONFIG == config.ChipmunkConfig()
