"""The correctness check's controls, on the card at the cell's own size:
the program as configured meets every limit of its cell, and each
number's control fails its limit: the program with the lower-precision
path its limits file names (``mlp.is_fp8``: int8 / fp8 MLP weights, int8
activations in the sparse MLP) for the MLP's numbers, the reference from
e4m3 operands for the numbers that path leaves alone, the latent carried
in bfloat16 for ``euler_err``, the decoder in bfloat16 for
``pixel_err``.  Run on the card with

    python3 -m pytest -p no:cacheprovider -m cuda \\
        benchmarks/tests/test_bench_control_cuda.py
"""
import io
import json
import os
import sys
from contextlib import redirect_stdout

import pytest
import torch

from benchmarks.core.loader import load_module

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROL_OF = {'mlp_err': 'control', 'mlp_flip': 'control',
              'block_err': 'reference_fp8', 'attn_err': 'reference_fp8',
              'sel_regret': 'reference_fp8', 'euler_err': 'euler_bf16',
              'pixel_err': 'decode_bf16'}


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['flux1-dev.sparse.b1',
                                      'flux1-dev.dense.b1'])
def test_control_fails_where_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the port\'s kernels have no CPU '
                    'mode')
    cal = load_module(os.path.join(BENCH_DIR, 'calibrate.py'),
                      'bench_calibrate')
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cal.main(['--workload', workload, '--seeds', '20211',
                         '--control-seeds', '20211']) == 0
    row = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(os.path.join(BENCH_DIR, 'limits', f'{workload}.json')) as f:
        limits = json.load(f)['limits']
    print(json.dumps(row), file=sys.stderr)
    assert all(row['program'][k] <= v for k, v in limits.items()), row
    for k, v in limits.items():
        assert row[CONTROL_OF[k]][k] > v, (k, row)
