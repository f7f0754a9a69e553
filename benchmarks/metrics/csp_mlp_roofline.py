"""csp_mlp_roofline: the least time of a generation's sparse MLP kernel
pairs (counts/<config>.py) over the traced device time of every
gemm_sm90_kernel<Mm1Bf16> and <Mm2Bf16> launch of the generation, in
percent."""


def read(run):
    if run.trace is None or not run.counts.get('mlp_bound_s'):
        return None
    t = run.trace.device_s(lambda n: 'mm1bf16<' in n.lower()
                           or 'mm2bf16<' in n.lower())
    if t <= 0:
        return None
    return 100.0 * run.counts['mlp_bound_s'] / (t / run.trace.generations)
