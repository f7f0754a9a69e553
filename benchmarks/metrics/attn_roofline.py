"""attn_roofline: the least time of a generation's attention launches
(counts/<config>.py: operations at the bf16 peak or bytes at the HBM
peak, whichever is larger, from the configuration's shapes and kept
share) over the traced device time of every attn_sm90_kernel launch of
the generation, in percent."""


def read(run):
    if run.trace is None or not run.counts.get('attn_bound_s'):
        return None
    t = run.trace.device_s(lambda n: 'attn_sm90_kernel' in n.lower())
    if t <= 0:
        return None
    return 100.0 * run.counts['attn_bound_s'] / (t / run.trace.generations)
