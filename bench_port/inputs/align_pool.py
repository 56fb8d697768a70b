"""The align cells' pool: the seeded stack written as stitched sections
(2 x 2 uncompressed PNG tiles and a metadata.txt each) in a work dir, with
the configuration's YAML beside it."""

import os

from inputs import align_stack
from inputs.texture import seeds
from inputs.workdir import write_config, write_pngs


def names(n):
    return [f's{z:04d}' for z in range(n)]


def write_pool(cell, n):
    """Make and write the stack; returns (work dir, config folder, section
    names, drift, the base texture's seed)."""
    d = cell.config['deployment']
    s_drift, s_tex = seeds(cell.seed, 2)
    drift = align_stack.drift(d, n, s_drift)
    base = align_stack.base(cell.dev, d, s_tex)
    wd = os.path.join(cell.work, 'pool', 'wd')
    tile = d['tile']
    sections = names(n)
    for z, name in enumerate(sections):
        img = align_stack.section(cell.dev, d, base, drift, z).cpu().numpy()
        sec = os.path.join(wd, 'stitched_sections', 'mip0', name)
        lines = ['{ROOT_DIR}\t' + sec, f'{{RESOLUTION}}\t{d["resolution_nm"]}']
        jobs = []
        for r in range(0, d['section'], tile):
            for c in range(0, d['section'], tile):
                fn = f'{name}_tr{r // tile + 1}-tc{c // tile + 1}.png'
                jobs.append((os.path.join(sec, fn), img[r:r + tile, c:c + tile]))
                lines.append(f'{fn}\t{c}\t{r}\t{c + tile}\t{r + tile}')
        write_pngs(jobs, compression=0)
        with open(os.path.join(sec, 'metadata.txt'), 'w') as f:
            f.write('\n'.join(lines) + '\n')
    cfg = write_config(cell.config, os.path.join(cell.work, 'pool'), wd)
    return wd, cfg, sections, drift, s_tex


def pass_dir(cell, pool_wd, tag, links):
    """A fresh work dir (and config folder) for pass ``tag``, holding links
    to the pool's ``links`` (paths under its work dir)."""
    root = os.path.join(cell.work, f'pass_{tag}')
    wd = os.path.join(root, 'wd')
    for rel in links:
        dst = os.path.join(wd, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.symlink(os.path.join(pool_wd, rel), dst)
    return write_config(cell.config, root, wd), wd
