"""Busy and idle time from a trace's own timeline."""
import pytest

from benchmarks.core.trace import Trace, from_chrome, is_gemm, is_glue, ours


def k(name, s, e):
    return (name, float(s), float(e))


def test_idle_is_the_window_minus_the_union_of_kernels():
    t = Trace(kernels=[k('a', 0, 10), k('b', 5, 20), k('c', 30, 40)],
              runtime=[k('cudaLaunchKernel', 0, 1),
                       k('cudaDeviceSynchronize', 40, 50)])
    assert t.window_s() == pytest.approx(50e-6)
    assert t.busy_s() == pytest.approx(30e-6)
    assert t.idle_pct() == pytest.approx(40.0)


def test_overlapping_kernels_never_read_over_the_window():
    # four streams' worth of kernels over the same 10 us: a sum of kernel
    # times would read 400% busy
    t = Trace(kernels=[k(f'k{i}', 0, 10) for i in range(4)])
    assert t.busy_s() == pytest.approx(10e-6)
    assert t.idle_pct() == pytest.approx(0.0)
    assert t.device_s(lambda n: True) == pytest.approx(40e-6)


def test_kernels_outside_the_window_are_clipped():
    t = Trace(kernels=[k('a', -5, 5), k('b', 8, 30)], window=(0.0, 10.0))
    assert t.busy_s() == pytest.approx(7e-6)
    assert 0.0 <= t.idle_pct() <= 100.0


def test_gaps_are_named_by_what_the_host_did():
    t = Trace(kernels=[k('a', 0, 10), k('b', 100, 110), k('c', 112, 120)],
              runtime=[k('cudaStreamSynchronize', 10, 99),
                       k('cudaLaunchKernel', 111, 111.5)])
    gaps = t.idle_gaps()
    assert gaps[0][0] == 'host in cudaStreamSynchronize'
    assert gaps[0][1] == pytest.approx(90e-6)
    assert gaps[1][0] == 'host before c'
    assert len(gaps) == 2


def test_chrome_events_are_read_by_category():
    ev = [{'ph': 'X', 'cat': 'kernel', 'name': 'void attn_sm90_kernel<x>',
           'ts': 1.0, 'dur': 2.0},
          {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD',
           'ts': 4.0, 'dur': 1.0},
          {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
           'ts': 0.5, 'dur': 0.2},
          {'ph': 'i', 'cat': 'kernel', 'name': 'marker', 'ts': 3.0},
          {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mm', 'ts': 0.0,
           'dur': 9.0}]
    t = from_chrome(ev)
    assert [x[0] for x in t.kernels] == ['void attn_sm90_kernel<x>',
                                         'Memcpy HtoD']
    assert [x[0] for x in t.runtime] == ['cudaLaunchKernel']
    assert t.busy_s() == pytest.approx(3e-6)


def test_kernel_groups():
    assert ours('void attn_sm90_kernel<DenseKeys, 3, false>(...)')
    assert ours('void gemm_sm90_kernel<Mm1Bf16<256, unsigned char> >()')
    assert is_gemm('nvjet_tst_192x192_64x4_2x1_v_bz_TNT')
    assert is_gemm('sm90_xmma_fprop_implicit_gemm_bf16')
    assert is_glue('void at::native::vectorized_elementwise_kernel<4>')
    assert not is_glue('void attn_sm90_kernel<CspKeys<8>>')
