"""A/B timing of the port's CUDA kernels on one NVIDIA GPU.

    python3 kernel_ab.py [--other NAME=DIR ...] [--levels 90 ...]

Builds this tree's kernels and those of each ``--other`` tree with
``_build.py``, printing ptxas's registers, shared memory and spills for
each.  An other tree is a directory holding
``xarray_parcel_tpu_torch/csrc`` with the same C interface: for instance
``git archive`` of the parent commit unpacked into ``dist/parent``, or a
copy of this tree with a kernel's block size changed.

First the most-unstable prep (``parcels.most_unstable_kernel``, depth
250 hPa), held bit for bit (``chip_smoke.same_bits``), and the mixed
layers of both depths (``parcels.mix_layers_kernel``), held as
``chip_smoke.compare_mix`` holds the kernel to its twin, each at each
device cell's shape on the cell's own float32 columns
(``chip_smoke.cell_columns``), with the plain twin's time beside the
trees'.
Then, at 786,432 columns (the ``chip_smoke.synthetic`` soundings, surface
parcel) of the first width in ``--levels`` (90 by default), for the solve
in float32 and float64 (also float32 with the profile tracks) and the
pre-pass, the tail and the neighbours in both, and for each of the four
in float32 at every further width, it calls the kernels
``fused.cape_cin_kernel``, ``fused.prepass_kernel``,
``diagnostics.diag_kernel`` and ``parcels.bridge_neighbors_kernel`` with
each tree's kernels (``_build.kernels_from``), holds each tree's outputs
against the first tree's (float64: identical NaN patterns and 1e-6;
float32: the budget; the pre-pass as ``chip_smoke.compare_prepass`` holds
it to its twin; the neighbours bit for bit) and times each with CUDA
events, the trees in turns (a b c ... c b a).  The neighbours take
contiguous terrain-following columns and, at each width in float32, the
broadcast of one row of isobaric levels (``chip_smoke.neighbor_inputs``).
The last line is one JSON object: each tree's mean milliseconds per
launch in each case, the case's bound (``chip_smoke.bound``) and the
card's name and power limit.

The solve's default options go through the library's
``fused_cape_cin_<dtype>`` entry points, which every tree has had since the
first kernel, so older trees time as before.  The case with all four
options set calls ``fused_cape_cin_flags_<dtype>``, which takes the flags
word: a tree from before the options has no such entry point and is left
out of that case (its line says so), as a tree without the pre-pass
kernel (``parcel_prepass_<dtype>``), the neighbours kernel
(``bridge_neighbors_<dtype>``), the mixed-layer kernel
(``mix_layers_f32``) or the most-unstable kernel (``most_unstable_f32``)
is out of their cases.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

import chip_smoke
import xarray_parcel_tpu_torch as xt
from xarray_parcel_tpu_torch import _build, fused, parcels, thermo
from xarray_parcel_tpu_torch import diagnostics as diag

REPEATS = 10                    # launches timed per turn, after a warm-up
MIX_DEPTHS = (100.0, 50.0)      # the full pipeline's mixed layers


# The entry point that only trees with the solve's options have.
FLAGS_ENTRY = 'fused_cape_cin_flags_f32'


def solve(args, with_profile, **options):
    """The solve's outputs by name, and with ``with_profile`` each track's
    every 17th value (``chip_smoke.compare`` takes a quantile, which a
    whole track is too long for)."""
    got = fused.cape_cin_kernel(*args, with_profile=with_profile, **options)
    if not with_profile:
        return dict(zip(fused.OUTPUTS, got))
    out, prof = got
    return {**dict(zip(fused.OUTPUTS, out)),
            **{k: v.flatten()[::17] for k, v in zip(fused.PROFILE, prof)}}


def tail(args):
    return dict(zip(diag.DIAG_OUTPUTS, diag.diag_kernel(*args)))


def held(dname):
    """A case's check of one tree's outputs against the first's."""
    return lambda name, got, want: chip_smoke.compare(name, got, want, dname)


def cases_at(L, dtypes, coeffs, dev):
    """{case: (run(), bound, dtype name, entry point a tree must have or
    None, check(name, got, want))} at 786,432 x L."""
    data, td = chip_smoke.synthetic(chip_smoke.MAIN_COLUMNS, L=L)
    cases = {}
    for dtype in dtypes:
        dname = str(dtype).split('.')[-1]
        tab = xt.AdiabatTables(coeffs.to(dtype))
        # Contiguous, as the fused pipeline hands them to the solve (the
        # synthetic pressure is column-major, which the wrapper would copy).
        p, t, h = (torch.as_tensor(data[k], dtype=dtype,
                                   device=dev).contiguous()
                   for k in ('pressure', 'temperature', 'height_asl'))
        tdd = torch.as_tensor(td, dtype=dtype, device=dev).contiguous()
        args = (p, t, tdd, *fused.prepass(p, p[:, 0], t[:, 0], tdd[:, 0],
                                          tab))
        cases[f'solve {dname} L={L}'] = (
            lambda a=args: solve(a, False),
            chip_smoke.bound(*chip_smoke.solve_work(*args), dtype), dname,
            None, held(dname), None)
        suffix = dname.replace('float', 'f')
        pargs = (p, *(x[:, 0].contiguous() for x in (p, t, tdd)), tab)
        cases[f'prepass {dname} L={L}'] = (
            lambda a=pargs: fused.prepass_kernel(*a),
            chip_smoke.bound(*chip_smoke.prepass_work(p, args[5]), dtype),
            dname, f'parcel_prepass_{suffix}', chip_smoke.compare_prepass,
            None)
        if dtype == torch.float32 and len(dtypes) > 1:
            cases[f'solve {dname} L={L} with tracks'] = (
                lambda a=args: solve(a, True), None, dname, None,
                held(dname), None)
            cases[f'solve {dname} L={L} all four options'] = (
                lambda a=args: solve(a, False,
                                     **chip_smoke.SOLVE_OPTIONS[-1]),
                None, dname, FLAGS_ENTRY, held(dname), None)
        targs = (p, t, tdd, h)
        cases[f'tail {dname} L={L}'] = (
            lambda a=targs: tail(a),
            chip_smoke.bound(*chip_smoke.tail_work(*targs), dtype), dname,
            None, held(dname), None)
        layouts = (False, True) if dtype == torch.float32 else (False,)
        entry = f'bridge_neighbors_{suffix}'
        for broadcast in layouts:
            nargs = tuple(x.to(dtype) if x.is_floating_point() else x
                          for x in chip_smoke.neighbor_inputs(
                              chip_smoke.MAIN_COLUMNS, L, broadcast, dev))
            cases[f'neighbors {dname} L={L}'
                  f'{" broadcast" if broadcast else ""}'] = (
                lambda a=nargs: parcels.bridge_neighbors_kernel(*a),
                chip_smoke.bound(*chip_smoke.neighbors_work(*nargs), dtype),
                dname, entry, chip_smoke.same_bits, None)
    return cases


def mix_cases(dev):
    """{case: (run(), bound, 'float32', entry point, check, twin())}: the
    mixed layers of both depths at each device cell's shape, on the cell's
    own columns (``chip_smoke.cell_columns``)."""
    cases = {}
    for label, B, L, broadcast in chip_smoke.NEIGHBOR_SHAPES:
        dat, _ = chip_smoke.cell_columns(label, dev)
        p, t = dat['pressure'], dat['temperature']
        args = (p, t, thermo.dewpoint_from_specific_humidity(
            p, t, dat['specific_humidity']), MIX_DEPTHS)
        cases[f'mixed layers {label} {B} x {L}'
              f'{" broadcast" if broadcast else ""}'] = (
            lambda a=args: parcels.mix_layers_kernel(*a),
            chip_smoke.bound(*chip_smoke.mix_work(p, t, MIX_DEPTHS),
                             torch.float32), 'float32', 'mix_layers_f32',
            lambda name, got, want, a=args: chip_smoke.compare_mix(
                name, got, want, MIX_DEPTHS, chip_smoke.mix_exact(*a)),
            lambda a=args: parcels._mix_layers_twin(*a))
    return cases


def mu_cases(dev):
    """{case: (run(), bound, 'float32', entry point, check, twin())}: the
    most-unstable prep of the fused pipelines (depth 250 hPa) at each
    device cell's shape, on the cell's own columns, held bit for bit."""
    cases = {}
    for label, B, L, broadcast in chip_smoke.NEIGHBOR_SHAPES:
        dat, _ = chip_smoke.cell_columns(label, dev)
        p, t = dat['pressure'], dat['temperature']
        args = (p, t, thermo.dewpoint_from_specific_humidity(
            p, t, dat['specific_humidity']), 250.0)
        cases[f'most-unstable {label} {B} x {L}'
              f'{" broadcast" if broadcast else ""}'] = (
            lambda a=args: parcels.most_unstable_kernel(*a),
            chip_smoke.bound(*chip_smoke.mu_work(p, t), torch.float32),
            'float32', 'most_unstable_f32', chip_smoke.same_bits,
            lambda a=args: parcels._most_unstable_twin(*a))
    return cases


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--other', action='append', default=[],
                    metavar='NAME=DIR', help='another tree to time')
    ap.add_argument('--levels', type=int, nargs='+', default=[90])
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print('kernel_ab: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    trees = {}
    for spec in opts.other:
        name, root = spec.split('=', 1)
        trees[name] = os.path.join(os.path.abspath(root),
                                   'xarray_parcel_tpu_torch', 'csrc')
    trees['this'] = _build.CSRC
    for name, csrc in trees.items():
        print(f'--- {name} ({csrc})', flush=True)
        _build.build(verbose=True, csrc=csrc)
        _build.load_library(csrc)

    def run_with(name, run):
        with _build.kernels_from(trees[name]):
            return run()

    coeffs = xt.AdiabatTables.build(dev, torch.float64).coeffs
    all_names = list(trees)
    result = {'device': smi, 'columns': chip_smoke.MAIN_COLUMNS, 'cases': {}}
    groups = [lambda: mu_cases(dev), lambda: mix_cases(dev)] + [
        lambda k=k, L=L: cases_at(
            L, (torch.float32, torch.float64) if k == 0 else (torch.float32,),
            coeffs, dev)
        for k, L in enumerate(opts.levels)]
    for group in groups:
        for case, (run, bnd, dname, needs, check, twin) in group().items():
            names = [n for n in all_names if needs is None
                     or hasattr(_build.load_library(trees[n]), needs)]
            left_out = [n for n in all_names if n not in names]
            want = run_with(names[0], run)
            times = {n: [] for n in names}
            for n in names + names[::-1]:
                ms, got = chip_smoke.cuda_ms(lambda: run_with(n, run),
                                             REPEATS)
                times[n].append(ms)
                if n != names[0]:
                    check(f'{case}/{n} vs {names[0]}/', got, want)
            row = {n: sum(v) / len(v) for n, v in times.items()}
            if bnd is not None:
                row['bound_ms'], row['bound_by'] = bnd
            if twin is not None:
                row['twin_ms'] = chip_smoke.cuda_ms(twin, 3)[0]
            result['cases'][case] = row
            print(f'{case}: ' + ', '.join(
                f'{n} {"/".join(f"{x:.3f}" for x in times[n])} ms'
                for n in names) + (f'; bound {bnd[0]:.3f} ms by {bnd[1]}'
                                   if bnd else '') + (
                f'; plain twin {row["twin_ms"]:.3f} ms' if twin else '') + (
                f'; without {needs}: {", ".join(left_out)}'
                if left_out else '') + f' ({smi})', flush=True)
            del want, got
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
