"""The readings that the limits of ``correct`` are set from, on the card at
the cells' own sizes: for each seed, the program's numbers against the
reference (the lower readings), the control's (the reference computed with
float8 matmul operands, put in the program's place) and the faults' (the
upper readings), each judged at the cell's committed limits as a run
judges it (``correct`` in each line).

    python benchmark/calibrate.py --workload segformer.train --seeds 11 12 13 \
        --control-seeds 11 12 13 --witness-seeds 11 --out chiprun_out/calibrate.jsonl

Train cells (no window: the readings are the first three steps): the
program's three steps against the reference's; the control's; half of each
batch left out (the reference on the first frame of each batch, the mean
over it) against the whole batch. A state left unchanged reads 1 on both
worst-leaf gaps by construction and needs no run. On the witness seeds two
readings more show what bf16 rounding alone does to each number: the
reference computed in bf16 against itself in float32, and the program run
at ``COMPUTE_DTYPE`` float32 against the reference. Serving cells: the
program's answers over a short window (``--seconds``) against the
reference; the control's argmax answers; one point's label altered in the
program's answers. One JSON line a seed and reading; train lines name the
worst leaves.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from benchmark import check as compare  # noqa: E402
from benchmark import run as harness  # noqa: E402


def _raw(readings: dict) -> dict:
    return {k: readings[k] for k in ('losses', 'grad_norms', 'change_norms')}


def _train_row(got: dict, ref: dict, raw: bool = True) -> dict:
    row = dict(compare.train_numbers(got, ref), worst=compare.worst_leaves(got, ref))
    if raw:
        row['raw'] = _raw(got)
    return row


def train_readings(loop, r, control: bool, witness: bool) -> list:
    """Rows of (kind, numbers); the readings themselves ride along under
    'raw' (losses and every leaf's norms), for a look at single leaves."""
    s = loop.setup(r, time.perf_counter())
    loop.release(s)
    ref = loop.reference_readings(s)
    out = [('program', dict(_train_row(s.readings, ref), finite=s.readings['finite'],
                            raw_reference=_raw(ref)))]
    if control:
        out.append(('control_fp8', _train_row(loop.reference_readings(s, 'fp8'), ref)))
        half = loop.reference_readings(s, frame_batches=[b[:1] for b in s.frame_batches])
        out.append(('fault_half_batch', _train_row(half, ref)))
    if witness:
        out.append(('witness_reference_bf16',
                    _train_row(loop.reference_readings(s, 'bf16'), ref, raw=False)))
        del s, ref
        r.config = json.loads(json.dumps(r.config))
        r.config['RUNTIME']['COMPUTE_DTYPE'] = 'float32'
        try:
            s = loop.setup(r, time.perf_counter())
            loop.release(s)
            out.append(('witness_program_float32',
                        dict(_train_row(s.readings, loop.reference_readings(s), raw=False),
                             finite=s.readings['finite'])))
        except Exception:   # a float32 step that does not fit on the card is a reading too
            out.append(('witness_program_float32',
                        {'traceback': traceback.format_exc()[-3000:]}))
    return out


def eval_readings(loop, r, control: bool, seconds: float) -> list:
    import torch
    s = loop.setup(r, time.perf_counter())
    measured = loop.window(s, seconds)
    loop.release(s)
    logits = loop.reference_logits(s)
    out = [('program', dict(loop.answers_gap(logits, s.answers),
                            answers=measured['attempted']))]
    if control:
        fp8 = loop.reference_logits(s, 'fp8')
        answers = [(i, lg.argmax(-1).to(torch.uint8).cpu().numpy()) for i, lg in enumerate(fp8)]
        out.append(('control_fp8', loop.answers_gap(logits, answers)))
        ring_index, labels = s.answers[0]
        labels = labels.copy()
        ref = logits[ring_index]
        point = int(torch.argmax(ref.max(-1).values - ref.min(-1).values))
        labels[point] = int(ref[point].argmin())
        out.append(('fault_answer_altered', loop.answers_gap(logits, [(ring_index, labels)])))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control-seeds', type=int, nargs='*', default=())
    ap.add_argument('--witness-seeds', type=int, nargs='*', default=())
    ap.add_argument('--seconds', type=float, default=5.0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('calibrate.py reads the card: no CUDA card found')
    harness.set_cache_dirs(HERE.parent)
    spec = json.loads((HERE.parent / 'BENCHMARK.json').read_text())
    cell = harness.Cell(spec, args.workload, HERE)
    with open(args.out, 'a') if args.out else contextlib.nullcontext() as out:
        for seed in args.seeds:
            r = harness.Run(cell, seed, torch.device('cuda', 0), False)
            t0 = time.perf_counter()
            control = seed in args.control_seeds
            try:
                if cell.loop_name == 'train':
                    rows = train_readings(cell.loop, r, control, seed in args.witness_seeds)
                else:
                    rows = eval_readings(cell.loop, r, control, args.seconds)
            except Exception:       # one seed's failure is a reading too: record it, go on
                rows = [('error', {'traceback': traceback.format_exc()[-3000:]})]
            for kind, numbers in rows:
                judged = compare.judge(numbers, cell.limits) if set(cell.limits) <= set(numbers) \
                    else {'correct': None}
                line = json.dumps({'workload': args.workload, 'seed': seed, 'kind': kind,
                                   'correct': judged['correct'], 'numbers': numbers,
                                   'seconds': time.perf_counter() - t0})
                print(line, flush=True)
                if out:
                    out.write(line + '\n')
                    out.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
