"""Compare the SASS of every kernel function of two trees whose kernels
are built (``build/chipmunk_torch/*.so`` under each root), function by
function, as ``cuobjdump -sass`` prints them (with runs of whitespace
collapsed: cuobjdump pads its columns to the widest instruction in the
file): one line per function, identical, differing, or present in one
tree only.  Names are matched
with the anonymous-namespace hash and ``CspKeys``' default ``SLOT``
argument left out::

    python3 chipmunk_torch/tools/sass_diff.py ROOT_A ROOT_B
"""
import glob, re, subprocess, sys

LIBS = ('flash_attention', 'csp_attention', 'csp_mlp', 'int8_probe')


def norm(name):
    name = re.sub(r'_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_[0-9a-f]{8}',
                  r'ANON_\1_', name)
    return re.sub(r'(CspKeysILi\d+E)Lb0E', r'\1', name)


def functions(path):
    """{normalised name: SASS lines} of one library."""
    out = subprocess.run(['/usr/local/cuda/bin/cuobjdump', '-sass', path],
                         capture_output=True, text=True, check=True).stdout
    res, cur, body = {}, None, []
    for line in out.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            if cur:
                res[norm(cur)] = body
            cur, body = m.group(1), []
        elif cur and '/*' in line:
            body.append(' '.join(line.split()))   # cuobjdump pads columns
    if cur:
        res[norm(cur)] = body
    return res


def main():
    roots = sys.argv[1:3]
    for lib in LIBS:
        fa, fb = (functions(glob.glob(
            f'{r}/build/chipmunk_torch/{lib}-*.so')[0]) for r in roots)
        for n in sorted(set(fa) | set(fb)):
            short = re.sub(r'^_ZN(8chipmunk4sm90\d\d|\d+ANON_[a-z0-9_]+?_\d+)',
                           '', n)[:100]
            if n not in fa or n not in fb:
                where = roots[1] if n in fb else roots[0]
                print(f'SASS {lib} {short}: only in {where}')
            else:
                same = 'identical' if fa[n] == fb[n] else 'DIFFERS'
                print(f'SASS {lib} {short}: {same} ({len(fa[n])} / '
                      f'{len(fb[n])} lines)')


if __name__ == '__main__':
    main()
