"""Layered YAML configuration.

Repo defaults under ``configs/`` are deep-merged with per-project overrides
under ``<working_directory>/configs/``.  Mirrors the accessor surface of the
reference (``feabas/config.py:97-310``) but caches are explicit and
resettable so tests and long-lived services can repoint the working
directory (the reference uses import-time ``lru_cache`` which cannot).

Set the environment variable ``FEABAS_TPU_CONFIG_DIR`` to override where the
general configs live (defaults: ``./configs`` if it holds a
``general_configs.yaml``, else the repo's bundled ``configs/``).

The port's copy of ``feabas_tpu/config.py``, cut to what the port reaches.
"""

import math
import os
from functools import lru_cache

from feabas_tpu_torch import constant
from feabas_tpu_torch import storage

# tensorstore / checkpoint knobs (reference: feabas/config.py:28-35)
TS_RETRY = 2
TS_TIMEOUT = 60.0  # seconds per tensorstore op before reconnect
CHECKPOINT_TIME_INTERVAL = 300.0  # seconds between volume-render flag flushes
DEFAULT_AVG_DEFORM = 0.05
# during matching one mesh is treated as far more rigid than the other so
# the two-mesh spring system cannot collapse (reference: feabas/config.py:35)
MATCH_SOFTFACTOR_DOMINANCE = 200


def _repo_config_dir():
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'configs')


def default_configuration_folder():
    env = os.environ.get('FEABAS_TPU_CONFIG_DIR', None)
    if env:
        return env
    cwd_configs = os.path.join(os.getcwd(), 'configs')
    if os.path.isfile(os.path.join(cwd_configs, 'general_configs.yaml')):
        return cwd_configs
    parent_configs = os.path.join(os.path.dirname(os.getcwd()), 'configs')
    if os.path.isfile(os.path.join(parent_configs, 'general_configs.yaml')):
        return parent_configs
    return _repo_config_dir()


def merge_config(base, override):
    """Recursive dict merge; ``override`` wins. Returns ``base`` mutated."""
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k, None), dict):
            merge_config(base[k], v)
        else:
            base[k] = v
    return base


def load_yaml_configs(file_default, file_user=None):
    conf = storage.load_yaml(file_default, default={})
    if file_user is not None:
        merge_config(conf, storage.load_yaml(file_user, default={}))
    return conf


@lru_cache(maxsize=None)
def _general_settings_cached(config_dir):
    conf = storage.load_yaml(os.path.join(config_dir, 'general_configs.yaml'), default={})
    if conf.get('cpu_budget', None) is None:
        try:
            import psutil
            conf['cpu_budget'] = psutil.cpu_count(logical=False) or os.cpu_count()
        except ImportError:
            conf['cpu_budget'] = os.cpu_count()
    return conf


def general_settings():
    return _general_settings_cached(default_configuration_folder())


def clear_config_caches():
    _general_settings_cached.cache_clear()
    _pipeline_configs_cached.cache_clear()
    _data_resolution_cached.cache_clear()
    _material_table_cached.cache_clear()
    storage.clear_exists_cache()


def parallel_framework():
    frmwk = str(general_settings().get('parallel_framework', 'process'))
    if frmwk.startswith('pr') or frmwk == 'builtin':
        return 'process'
    if frmwk.startswith('th'):
        return 'thread'
    if frmwk.startswith('se') or frmwk == 'none':
        return 'serial'
    if frmwk.startswith('sl'):
        return 'slurm'
    raise ValueError(f'unsupported parallel framework "{frmwk}"')


def ts_timeout():
    """Seconds before a hung tensorstore op raises (general_configs
    ``tensorstore_timeout``; falls back to TS_TIMEOUT)."""
    v = general_settings().get('tensorstore_timeout', None)
    return TS_TIMEOUT if v is None else float(v)


def fft_batch():
    """Default xcorr batch size (general_configs ``device.fft_batch``)."""
    dev = general_settings().get('device', {}) or {}
    return int(dev.get('fft_batch', 128) or 128)


def device_render():
    """general_configs ``device.render``: route MeshRenderer crops through
    the device engine (feabas_tpu_torch/ops/render.py); per-call
    ``device_render=`` kwargs override. ``auto`` (the shipped default) is
    the device engine on a CUDA device and the host cv2 path elsewhere
    (``renderer.resolve_device_render``)."""
    dev = general_settings().get('device', {}) or {}
    return dev.get('render', 'auto')


def get_work_dir():
    work_dir = general_settings().get('working_directory', './work_dir')
    return storage.expand_dir(work_dir)


def get_log_dir():
    log_dir = general_settings().get('logging_directory', None)
    if log_dir is None:
        log_dir = storage.join_paths(get_work_dir(), 'logs')
    return log_dir


_PIPELINES = {
    'stitch': ('default_stitching_configs.yaml', 'stitching_configs.yaml'),
    'align': ('default_alignment_configs.yaml', 'alignment_configs.yaml'),
    'thumbnail': ('default_thumbnail_configs.yaml', 'thumbnail_configs.yaml'),
}


def _default_file(name):
    """A default_*.yaml from the active config folder, falling back to the
    repo-bundled copy when a project config folder omits it."""
    f = storage.join_paths(default_configuration_folder(), name)
    if not storage.file_exists(f):
        bundled = storage.join_paths(_repo_config_dir(), name)
        if storage.file_exists(bundled):
            return bundled
    return f


def config_files(pipeline):
    default_name, user_name = _PIPELINES[pipeline]
    file_default = _default_file(default_name)
    file_user = storage.join_paths(get_work_dir(), 'configs', user_name)
    return file_default, file_user


@lru_cache(maxsize=None)
def _pipeline_configs_cached(pipeline, config_dir, work_dir):
    del config_dir, work_dir  # cache key components only
    conf = load_yaml_configs(*config_files(pipeline))
    if pipeline == 'align':
        # default fine-matching mip so xy resolution ~ section thickness
        # (reference: feabas/config.py:148-156, README.md:213)
        thickness = section_thickness()
        matching = conf.setdefault('matching', {})
        if matching.get('working_mip_level', None) is None:
            mres = montage_resolution()
            matching['working_mip_level'] = max(0, math.floor(math.log2(max(thickness / mres, 1.0))))
    return conf


def _pipeline_configs(pipeline):
    return _pipeline_configs_cached(pipeline, default_configuration_folder(), get_work_dir())


def stitch_configs():
    return _pipeline_configs('stitch')


def align_configs():
    return _pipeline_configs('align')


def thumbnail_configs():
    return _pipeline_configs('thumbnail')


def section_thickness():
    conf = storage.load_yaml(config_files('stitch')[1], default={})
    if conf.get('section_thickness', None) is not None:
        return conf['section_thickness']
    dconf = storage.load_yaml(config_files('stitch')[0], default={})
    if dconf.get('section_thickness', None) is not None:
        return dconf['section_thickness']
    return general_settings().get('section_thickness', constant.DEFAULT_THICKNESS)


def material_table_file():
    mt_default = _default_file('default_material_table.yaml')
    mt_user = storage.join_paths(get_work_dir(), 'configs', 'material_table.yaml')
    if not storage.file_exists(mt_default):
        mt_default = None
    if not storage.file_exists(mt_user):
        mt_user = None
    return mt_default, mt_user


@lru_cache(maxsize=None)
def _material_table_cached(mt_default, mt_user):
    from feabas_tpu_torch.material import MaterialTable
    if mt_default is None and mt_user is None:
        return MaterialTable()
    if mt_user is None:
        return MaterialTable.from_pickleable(mt_default)
    mt = MaterialTable.from_pickleable(mt_user)
    if mt_default is not None:
        mt.combine_material_table(MaterialTable.from_pickleable(mt_default), force_update=False)
    return mt


def material_table():
    # parsed once per (default, user) file pair: every Mesh construction
    # asks for this, and uncached YAML parsing was ~20% of the stitch
    # matching profile. Callers get a COPY so local mutation stays local.
    mt = _material_table_cached(*material_table_file())
    return mt.copy()


# ------------------------- resolution bookkeeping ------------------------- #

@lru_cache(maxsize=None)
def _data_resolution_cached(work_dir, config_dir):
    """Full (mip0) resolution in nm/px.

    Priority: cached ``configs/resolutions.yaml`` in the work dir → the
    ``{RESOLUTION}`` header of any stitch coordinate file → general config
    ``full_resolution`` (reference: feabas/config.py:211-258).
    """
    del config_dir
    res_file = storage.join_paths(work_dir, 'configs', 'resolutions.yaml')
    cached = storage.load_yaml(res_file, default={})
    if cached.get('full_resolution', None) is not None:
        return float(cached['full_resolution'])
    coord_dir = storage.join_paths(work_dir, 'stitch', 'stitch_coord')
    res = None
    if storage.file_exists(coord_dir):
        for coord_file in storage.list_folder_content(storage.join_paths(coord_dir, '*.txt'))[:1]:
            with storage.File(coord_file, 'r') as f:
                for line in f:
                    if '{RESOLUTION}' in line:
                        res = float(line.strip().split('\t')[1])
                        break
                    if not line.startswith('{'):
                        break
    if res is None:
        res = float(general_settings().get('full_resolution', constant.DEFAULT_RESOLUTION))
    try:
        storage.save_yaml(res_file, {'full_resolution': float(res)})
    except Exception:
        pass  # read-only work dirs are fine; we just lose the cache
    return float(res)


def data_resolution():
    return _data_resolution_cached(get_work_dir(), default_configuration_folder())


def montage_resolution():
    """Resolution of stitched montages (rendering may rescale mip0)."""
    conf = stitch_configs().get('rendering', {})
    res = conf.get('resolution', None)
    if res is not None:
        return float(res)
    return data_resolution()


def thumbnail_resolution():
    conf = thumbnail_configs().get('downsample', {})
    res = conf.get('thumbnail_mip_level', None)
    if res is not None:
        return montage_resolution() * (2 ** int(res))
    return montage_resolution() * (2 ** 6)


def align_resolution():
    mip = align_configs().get('matching', {}).get('working_mip_level', 0)
    return montage_resolution() * (2 ** int(mip))


# ------------------------- thread budgeting ------------------------- #

def limit_numpy_thread(nthreads):
    nthreads = max(1, int(nthreads))
    for var in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS',
                'VECLIB_MAXIMUM_THREADS', 'NUMEXPR_NUM_THREADS'):
        os.environ[var] = str(nthreads)
    try:
        import cv2
        cv2.setNumThreads(nthreads)
    except ImportError:
        pass


def set_numpy_thread_from_num_workers(num_workers):
    cpu_budget = general_settings().get('cpu_budget', None) or os.cpu_count()
    num_workers = max(1, min(int(num_workers), cpu_budget))
    limit_numpy_thread(max(1, cpu_budget // num_workers))
    return num_workers


