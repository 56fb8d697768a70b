"""Host-side work distribution.

One entry point, :func:`submit_to_workers`, yields results as they complete
from interchangeable backends (reference: ``feabas/concurrent.py:30-182``):

- ``process``: spawned ``ProcessPoolExecutor`` (default; isolates native
  library state and keeps the CUDA context out of workers),
- ``thread``: ``ThreadPoolExecutor`` (for IO-bound fan-out that must share
  the in-process device),
- ``serial``: in-line execution (num_workers<=1, tests, nested pools),
- ``slurm``: multi-node batch scheduling — jobs pickle to a shared spool
  directory, an ``sbatch``-submitted script runs
  ``python -m feabas_tpu_torch.remote_worker`` on a cluster node, and results
  come back as files (the dask-jobqueue replacement, reference:
  ``feabas/concurrent.py:147-182``).

Backends are swappable so every parallel path can also run serially —
this property is load-bearing for the test suite.

The port's copy of ``feabas_tpu/concurrent.py``, cut to what the port reaches.
"""

import multiprocessing as mp
import os
import pickle
import subprocess
import tempfile
import time
import uuid
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor, as_completed

from feabas_tpu_torch import config

REMOTE_FRAMEWORKS = ('slurm',)


def _in_daemon_process():
    return mp.current_process().daemon


def _normalize_jobs(args_list, kwargs_list):
    if args_list is None and kwargs_list is None:
        raise ValueError('at least one of args_list / kwargs_list required')
    if args_list is None:
        args_list = [()] * len(kwargs_list)
    if kwargs_list is None:
        kwargs_list = [{}] * len(args_list)
    if len(args_list) != len(kwargs_list):
        raise ValueError('args_list and kwargs_list length mismatch')
    return list(args_list), list(kwargs_list)


def submit_to_workers(func, args_list=None, kwargs_list=None, **settings):
    """Run ``func(*args, **kwargs)`` for each job; yield results as completed.

    Settings:
        num_workers: parallel width (<=1 → serial).
        parallel_framework: 'process' | 'thread' | 'serial'
            (default from general_configs.yaml).
        max_tasks_per_child: recycle worker processes after this many jobs.
    """
    args_list, kwargs_list = _normalize_jobs(args_list, kwargs_list)
    if not args_list:
        return
    num_workers = settings.pop('num_workers', 1) or 1
    framework = settings.get('parallel_framework', None) or config.parallel_framework()
    max_tasks_per_child = settings.get('max_tasks_per_child', None)
    # local pools degrade to serial for tiny workloads; REMOTE frameworks
    # do not — a single window handed to slurm must still run on the
    # cluster node, not in this process (reference force_remote:
    # concurrent.py:33,40). Daemon children always run serial.
    if _in_daemon_process():
        framework = 'serial'
    elif framework not in REMOTE_FRAMEWORKS and (
            (num_workers <= 1) or (len(args_list) <= 1)):
        framework = 'serial'
    num_workers = min(num_workers, len(args_list))
    if framework == 'serial':
        for args, kwargs in zip(args_list, kwargs_list):
            yield func(*args, **kwargs)
    elif framework == 'thread':
        with ThreadPoolExecutor(max_workers=num_workers) as executor:
            futures = [executor.submit(func, *args, **kwargs)
                       for args, kwargs in zip(args_list, kwargs_list)]
            for fut in as_completed(futures):
                yield fut.result()
    elif framework == 'process':
        ctx = mp.get_context('spawn')
        pool_kwargs = {'max_workers': num_workers, 'mp_context': ctx}
        if max_tasks_per_child is not None:
            pool_kwargs['max_tasks_per_child'] = int(max_tasks_per_child)
        with ProcessPoolExecutor(**pool_kwargs) as executor:
            futures = [executor.submit(func, *args, **kwargs)
                       for args, kwargs in zip(args_list, kwargs_list)]
            for fut in as_completed(futures):
                yield fut.result()
    elif framework == 'slurm':
        yield from _submit_slurm(func, args_list, kwargs_list,
                                 num_workers=num_workers, **settings)
    else:
        raise ValueError(f'unknown parallel framework: {framework}')


def _submit_slurm(func, args_list, kwargs_list, **settings):
    """File-spool batch backend: one scheduler job per work item.

    Each job is a pickled (module, func, args, kwargs) spec; an sbatch
    script runs ``python -m feabas_tpu_torch.remote_worker job.pkl out.pkl`` on a
    node that shares the spool filesystem; completion is an atomic
    rename of the result file. ``func`` must be an importable module-level
    function (all pipeline workers are).

    Settings:
        spool_dir: shared directory for job/result files (default: a
            temp dir under the working directory).
        sbatch_cmd: submit command (default 'sbatch'; tests substitute a
            local shim).
        slurm_options: list of extra '#SBATCH ...' option lines.
        poll_interval: result poll period in seconds.
        job_timeout: per-job wall-clock timeout in seconds (None = wait
            forever, matching scheduler-managed limits).
    """
    if func.__module__ == '__main__':
        raise ValueError('slurm backend needs an importable worker function')
    spool = settings.get('spool_dir', None)
    if spool is None:
        spool = os.path.join(tempfile.gettempdir(), 'feabas_tpu_spool')
    os.makedirs(spool, exist_ok=True)
    sbatch = settings.get('sbatch_cmd', 'sbatch')
    options = settings.get('slurm_options', []) or []
    poll_interval = float(settings.get('poll_interval', 1.0))
    job_timeout = settings.get('job_timeout', None)
    batch = uuid.uuid4().hex[:8]
    pending = {}
    import sys
    for k, (args, kwargs) in enumerate(zip(args_list, kwargs_list)):
        job = os.path.join(spool, f'{batch}_{k}.job.pkl')
        out = os.path.join(spool, f'{batch}_{k}.out.pkl')
        with open(job, 'wb') as f:
            pickle.dump({'module': func.__module__, 'func': func.__name__,
                         'args': args, 'kwargs': kwargs}, f)
        script = os.path.join(spool, f'{batch}_{k}.sh')
        pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        lines = ['#!/bin/bash'] + [f'#SBATCH {o}' for o in options] + [
            f'cd {os.getcwd()}',
            f'export PYTHONPATH={pkg_parent}:$PYTHONPATH',
            f'{sys.executable} -m feabas_tpu_torch.remote_worker {job} {out}',
        ]
        with open(script, 'w') as f:
            f.write('\n'.join(lines) + '\n')
        os.chmod(script, 0o755)
        subprocess.run([sbatch, script], check=True, capture_output=True)
        pending[k] = out
    t0 = time.time()
    while pending:
        done = []
        for k, out in pending.items():
            if os.path.exists(out):
                with open(out, 'rb') as f:
                    payload = pickle.load(f)
                done.append(k)
                if not payload.get('ok'):
                    raise RuntimeError(
                        f'remote job failed: {payload.get("error")}\n'
                        f'{payload.get("traceback", "")}')
                yield payload['result']
        for k in done:
            del pending[k]
        if pending:
            if job_timeout is not None and time.time() - t0 > job_timeout:
                raise TimeoutError(f'{len(pending)} remote job(s) timed out')
            time.sleep(poll_interval)
