"""Remote-job worker entry point.

``python -m feabas_tpu_torch.remote_worker <job.pkl> <out.pkl>`` re-hydrates a
pickled (module, function, args, kwargs) job, runs it, and writes the
result next to the job file. Together with the 'slurm' backend in
:mod:`feabas_tpu_torch.concurrent` this replaces the reference's
dask-jobqueue SLURM cluster (reference: feabas/concurrent.py:147,
aligner.py:909): jobs and results travel through the shared filesystem —
the same artifact-protocol coordination the pipelines already rely on —
so any batch scheduler that can run a shell script can host workers.

The port's copy of ``feabas_tpu/remote_worker.py``, cut to what the port reaches.
"""

import importlib
import pickle
import sys
import traceback


def run_job(job_path, out_path):
    with open(job_path, 'rb') as f:
        spec = pickle.load(f)
    tmp = out_path + '.tmp'
    try:
        mod = importlib.import_module(spec['module'])
        func = getattr(mod, spec['func'])
        result = func(*spec.get('args', ()), **spec.get('kwargs', {}))
        payload = {'ok': True, 'result': result}
    except Exception as e:  # ship the failure back instead of dying silently
        payload = {'ok': False, 'error': repr(e),
                   'traceback': traceback.format_exc()}
    with open(tmp, 'wb') as f:
        pickle.dump(payload, f)
    import os
    os.replace(tmp, out_path)  # atomic publish: pollers never see partials
    return payload


if __name__ == '__main__':
    out = run_job(sys.argv[1], sys.argv[2])
    sys.exit(0 if out.get('ok') else 1)
