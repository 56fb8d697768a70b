"""The comparison that decides ``correct``, shown to fail, on the CPU.

    FEABAS_TORCH_DEVICE=cpu python3 -m pytest bench_port/test_correct.py -q

Each case drives the rest of a run of a cell (set-up, window, the
comparison), past the harness's look for a card and at the small sizes of
``tiny_sizes.py``: a sound run must come out correct; the control (the
plain reference in bfloat16 in the program's place) and each fault planted
under the timed path must come out not correct. The control's readings at
the cells' own sizes come from ``control.py`` on the chip (PERF.md).
"""

import argparse
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness  # noqa: E402
import tiny_sizes  # noqa: E402

SEED = 2 ** 31 + 4321


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')


def _run(cell, patch=None, control=False, seconds=1.0):
    wl = harness.load_json(HERE, 'workloads', cell + '.json')
    entry = next(w for w in harness.load_json(harness.ROOT, 'BENCHMARK.json')
                 ['workloads'] if w['name'] == cell)
    conf = harness.load_json(HERE, 'configs', entry['config'] + '.json')
    tiny_sizes.shrink(cell, wl, conf)
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=seconds,
                              trace=0)
    return harness.run(args, require_cuda=False, workload=wl, config=conf,
                       patch=patch, control=control)


def _failing(checks):
    return sorted(n for n, c in checks.items() if not c['value'] <= c['limit'])


CELLS = ('align.match', 'stitch.section')


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct_and_the_control_is_not(cell):
    r = _run(cell, control=True)
    assert r['correct'], r['checks']
    assert r['attempted'] >= 1 and r['failed'] == 0
    assert _failing(r['control_checks']), r['control_checks']


# ---- faults planted under the timed path (after set-up, before the window)

def _stitch_unchanged(monkeypatch):
    from feabas_tpu_torch.stitcher import Stitcher
    for attr in ('optimize_translation', 'optimize_affine',
                 'optimize_group_intersection'):
        monkeypatch.setattr(Stitcher, attr, lambda self, **k: None)
    monkeypatch.setattr(Stitcher, 'optimize_elastic',
                        lambda self, **k: (0.0, 0.0))


def _stitch_half(monkeypatch):
    from feabas_tpu_torch.stitcher import Stitcher
    orig = Stitcher.dispatch_matchers

    def half(self, **k):
        n = orig(self, **k)
        for key in sorted(self.matches)[len(self.matches) // 2:]:
            del self.matches[key]
        return n
    monkeypatch.setattr(Stitcher, 'dispatch_matchers', half)


def _stitch_altered(monkeypatch):
    from feabas_tpu_torch import common
    orig = common.imwrite

    def shifted(path, img, *a, **k):
        return orig(path, np.roll(img, 1, axis=1), *a, **k)
    monkeypatch.setattr(common, 'imwrite', shifted)


def _stitch_match_altered(monkeypatch):
    from feabas_tpu_torch.stitcher import Stitcher
    orig = Stitcher.dispatch_matchers

    def altered(self, **k):
        n = orig(self, **k)
        m = self.matches[sorted(self.matches)[0]]
        m.xy1[:] = m.xy1 + 2.0
        return n
    monkeypatch.setattr(Stitcher, 'dispatch_matchers', altered)


def _match_unchanged(monkeypatch):
    """Each pair's matches left where the global seed put them: xy0 = xy1
    moved by mesh1's seed translation, as if no round moved the mesh."""
    from feabas_tpu_torch import matcher
    orig = matcher.section_matcher

    def seeded(mesh0, mesh1, *a, **k):
        shift = (mesh1.vertices_w_offset('MOVING')
                 - mesh1.vertices_w_offset('INITIAL')).mean(axis=0)
        m = orig(mesh0, mesh1, *a, **k)
        return None if m is None else type(m)(m.xy1 + shift, m.xy1,
                                              m.weight, m.strain)
    monkeypatch.setattr(matcher, 'section_matcher', seeded)


def _match_edit(monkeypatch, edit):
    from feabas_tpu_torch import matcher
    orig = matcher.section_matcher

    def edited(*a, **k):
        m = orig(*a, **k)
        return None if m is None else edit(m)
    monkeypatch.setattr(matcher, 'section_matcher', edited)


def _match_half(monkeypatch):
    def half(m):
        n = len(m.weight) // 2
        return type(m)(m.xy0[:n], m.xy1[:n], m.weight[:n], m.strain)
    _match_edit(monkeypatch, half)


def _match_altered(monkeypatch):
    def altered(m):
        return type(m)(m.xy0 + 2.5, m.xy1, m.weight, m.strain)
    _match_edit(monkeypatch, altered)


FAULTS = {
    ('stitch.section', 'state unchanged: no solve moves a tile'): _stitch_unchanged,
    ('stitch.section', 'half the overlaps left out'): _stitch_half,
    ('stitch.section', 'each blended block shifted by 1 px as written'): _stitch_altered,
    ('stitch.section', 'one overlap\'s matches moved by 2 px'): _stitch_match_altered,
    ('align.match', 'state unchanged: matches left at the global seed'): _match_unchanged,
    ('align.match', 'half of each pair\'s matches left out'): _match_half,
    ('align.match', 'matches moved by 2.5 working px'): _match_altered,
}


@pytest.mark.parametrize('cell, fault', sorted(FAULTS), ids=lambda v: v)
def test_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    r = _run(cell, patch=lambda state: FAULTS[cell, fault](monkeypatch))
    assert not r['correct'], (fault, r['checks'])
    assert _failing(r['checks']) or r['failed'], r['checks']


def test_a_run_without_a_card_exits_nonzero_with_no_result(tmp_path):
    import subprocess
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    p = subprocess.run([sys.executable, os.path.join(HERE, 'run.py'),
                        '--workload', 'align.match', '--seed', str(SEED),
                        '--seconds', '1', '--trace', '0'],
                       capture_output=True, text=True, env=env, cwd=tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ''
