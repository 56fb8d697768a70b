"""Logging: console + warning-file + archive-file sinks, multiprocess-safe.

Worker processes forward records through a ``multiprocessing`` queue to a
listener in the main process (capability parity with reference
``feabas/logging.py:56-151``).  File sinks may live on GCS: records are
buffered locally and uploaded when the handler closes.

The port's copy of ``feabas_tpu/logging.py``, cut to what the port reaches.
"""

import logging
import logging.handlers
import multiprocessing as mp
import os
import socket
import tempfile
import threading
import time

from feabas_tpu_torch import config, storage, trace

_LEVELS = {'DEBUG': logging.DEBUG, 'INFO': logging.INFO,
           'WARNING': logging.WARNING, 'ERROR': logging.ERROR,
           'NONE': logging.CRITICAL + 10}

_FMT = logging.Formatter('%(asctime)s %(levelname)s %(processName)s %(message)s')


def _level(name, default='INFO'):
    return _LEVELS.get(str(name or default).upper(), logging.INFO)


class CloudFileHandler(logging.FileHandler):
    """FileHandler that stages a local temp file and uploads on close."""

    def __init__(self, path, mode='a'):
        self._target = str(path)
        if storage.is_cloud_path(self._target):
            fd, self._local = tempfile.mkstemp(suffix='.log')
            os.close(fd)
        else:
            os.makedirs(os.path.dirname(self._target) or '.', exist_ok=True)
            self._local = self._target
        super().__init__(self._local, mode=mode)

    def close(self):
        super().close()
        if self._local != self._target:
            try:
                with open(self._local, 'rb') as f:
                    data = f.read()
                if data:
                    with storage.File(self._target, 'wb') as f:
                        f.write(data)
            finally:
                try:
                    os.remove(self._local)
                except OSError:
                    pass


def _log_paths(prefix=None):
    log_dir = config.get_log_dir()
    ts = time.strftime('%Y%m%d%H%M%S')
    host = socket.gethostname().split('.')[0]
    stem = f'{prefix + "_" if prefix else ""}{host}_{ts}_{os.getpid()}'
    return (storage.join_paths(log_dir, stem + '.log'),
            storage.join_paths(log_dir, stem + '_warnings.log'))


def get_main_logger(logger_name='feabas_tpu_torch', prefix=None):
    """Logger with console / warning-file / archive-file sinks, levels from
    general_configs.yaml (reference: feabas/logging.py:68-117)."""
    settings = config.general_settings()
    logger = logging.getLogger(logger_name)
    if getattr(logger, '_feabas_initialized', False):
        return logger
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    console = logging.StreamHandler()
    console.setLevel(_level(settings.get('console_level'), 'INFO'))
    console.setFormatter(_FMT)
    logger.addHandler(console)
    archive_level = _level(settings.get('archive_level'), 'INFO')
    logfile_level = _level(settings.get('logfile_level'), 'WARNING')
    if archive_level <= logging.CRITICAL or logfile_level <= logging.CRITICAL:
        archive_path, warn_path = _log_paths(prefix)
        if str(settings.get('archive_level', 'INFO')).upper() != 'NONE':
            fh = CloudFileHandler(archive_path)
            fh.setLevel(archive_level)
            fh.setFormatter(_FMT)
            logger.addHandler(fh)
        if str(settings.get('logfile_level', 'WARNING')).upper() != 'NONE':
            wh = CloudFileHandler(warn_path)
            wh.setLevel(max(logfile_level, logging.WARNING))
            wh.setFormatter(_FMT)
            logger.addHandler(wh)
    logger._feabas_initialized = True
    return logger


def _listener_loop(queue, logger_name):
    logger = logging.getLogger(logger_name)
    while True:
        try:
            record = queue.get()
        except (EOFError, OSError):
            break
        if record is None:
            break
        logger.handle(record)


def initialize_main_logger(logger_name='feabas_tpu_torch', mp_queue=True, prefix=None):
    """Create the main logger and, optionally, a queue + listener thread for
    cross-process log relay. Returns (logger_info, logger).

    ``logger_info`` is a picklable (name, queue) pair that workers pass to
    :func:`get_logger`."""
    logger = get_main_logger(logger_name, prefix=prefix)
    if not mp_queue:
        return (logger_name, None), logger
    queue = mp.Manager().Queue(-1)
    t = threading.Thread(target=_listener_loop, args=(queue, logger_name), daemon=True)
    t.start()
    return (logger_name, queue), logger


def get_logger(logger_info):
    """Worker-side logger. If a queue is provided, records relay to the main
    process; otherwise a local console logger is used."""
    if logger_info is None:
        return get_main_logger()
    name, queue = logger_info
    if queue is None:
        return logging.getLogger(name) if logging.getLogger(name).handlers else get_main_logger(name)
    logger = logging.getLogger(f'{name}.worker{os.getpid()}')
    if not logger.handlers:
        logger.setLevel(logging.DEBUG)
        logger.propagate = False
        logger.addHandler(logging.handlers.QueueHandler(queue))
    return logger


def terminate_logger(logger_info, logger=None):
    name, queue = logger_info if logger_info else (None, None)
    if queue is not None:
        try:
            queue.put(None)
        except Exception:
            pass
    logger = logger or (logging.getLogger(name) if name else None)
    if logger is not None:
        for h in list(logger.handlers):
            h.close()
            logger.removeHandler(h)
        logger._feabas_initialized = False


class stage_timer:
    """Context manager timing a pipeline stage: the span ``trace.span(stage)``
    for its duration, and its wall time logged (the in-driver stage timing
    the reference scatters through its CLIs,
    reference: stitch_main.py:43,210, aligner.py:741).

    Usage::

        with stage_timer(logger, 'matching', section='s0001'):
            ...

    Logs "<stage> [k=v ...]: <dt>s" at INFO on success; failures log the
    elapsed time at ERROR and re-raise. With ``logger=None`` it logs
    nothing: the span alone, and ``elapsed`` for the caller's own line.
    Nesting is fine.
    """

    def __init__(self, logger, stage, level=logging.INFO, **context):
        self._logger = logger
        self._stage = stage
        self._level = level
        self._context = context
        self._t0 = None
        self._span = None

    def __enter__(self):
        self._span = trace.span(self._stage)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    @property
    def elapsed(self):
        return time.perf_counter() - self._t0

    def _fmt(self):
        ctx = ' '.join(f'{k}={v}' for k, v in self._context.items())
        return f'{self._stage}{" [" + ctx + "]" if ctx else ""}'

    def __exit__(self, exc_type, exc, tb):
        dt = self.elapsed
        self._span.__exit__(exc_type, exc, tb)
        if self._logger is None:
            return False
        if exc_type is None:
            self._logger.log(self._level, f'{self._fmt()}: {dt:.2f}s')
        else:
            self._logger.error(f'{self._fmt()}: FAILED after {dt:.2f}s '
                               f'({exc_type.__name__}: {exc})')
        return False
