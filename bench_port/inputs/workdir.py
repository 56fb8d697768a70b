"""Work dirs laid out as the port's drivers read them: a config folder
(the configuration file's YAML, as run) and a work dir with its pipeline
override, and PNG tiles written in bulk."""

import copy
import os
from concurrent.futures import ThreadPoolExecutor

import cv2
import yaml



def _merge(base, over):
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


def _dump(path, data):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        yaml.safe_dump(data, f, default_flow_style=False)


def write_config(conf, root, work_dir):
    """The configuration file's YAML files under ``root/configs`` (general
    settings pointed at ``work_dir``) and its pipeline override under
    ``work_dir/configs``. Returns the config folder."""
    cfg = os.path.join(root, 'configs')
    for name, data in conf['files'].items():
        data = copy.deepcopy(data)
        _merge(data, conf['overrides'].get(name, {}))
        if name == 'general_configs.yaml':
            data['working_directory'] = work_dir
        _dump(os.path.join(cfg, name), data)
    for name, data in conf['overrides'].items():
        if name not in conf['files']:
            _dump(os.path.join(work_dir, 'configs', name), data)
    return cfg


def use_config(cfg):
    """Point the program's config system at the folder ``cfg`` (its caches
    cleared: they key on the folder read before)."""
    os.environ['FEABAS_TPU_CONFIG_DIR'] = cfg
    from feabas_tpu_torch import config
    config.clear_config_caches()


def write_pngs(jobs, compression=None):
    """[(path, uint8 array)] written by 8 threads (``compression`` the PNG
    level, cv2's default where None)."""
    params = [] if compression is None else [cv2.IMWRITE_PNG_COMPRESSION,
                                             compression]

    def write(job):
        os.makedirs(os.path.dirname(job[0]), exist_ok=True)
        if not cv2.imwrite(job[0], job[1], params):
            raise OSError(f'could not write {job[0]}')

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))


def read_rendered(out_dir, bbox):
    """Crop ``bbox`` (x0, y0, x1, y1) of a rendered section from the output
    tiles its metadata.txt lists (zero where none)."""
    import numpy as np
    x0, y0, x1, y1 = bbox
    out = np.zeros((y1 - y0, x1 - x0), np.uint8)
    with open(os.path.join(out_dir, 'metadata.txt')) as f:
        rows = [ln.rstrip('\n').split('\t') for ln in f if not ln.startswith('{')]
    for fname, *b in rows:
        tx0, ty0, tx1, ty1 = (int(float(v)) for v in b)
        ix0, iy0, ix1, iy1 = max(x0, tx0), max(y0, ty0), min(x1, tx1), min(y1, ty1)
        if ix1 <= ix0 or iy1 <= iy0:
            continue
        img = cv2.imread(os.path.join(out_dir, fname), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise OSError(f'could not read {fname}')
        out[iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0] = \
            img[iy0 - ty0:iy1 - ty0, ix0 - tx0:ix1 - tx0]
    return out
