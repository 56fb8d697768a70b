"""Uniform file operations over local filesystem and cloud buckets.

Provides the small surface the rest of the framework relies on: path joins
that respect URL schemes, globbing, existence checks, text/binary file
handles, and an HDF5 handle class that stages cloud files through a local
temporary copy.  (Capability parity with reference ``feabas/storage.py``;
GCS support is gated on the ``google-cloud-storage`` wheel being present.)

The port's copy of ``feabas_tpu/storage.py``, cut to what the port reaches.
"""

import errno
import glob as _glob
import os
import re
import shutil
import tempfile
from contextlib import contextmanager
from functools import lru_cache

import yaml

try:
    import h5py
except ImportError:     # the port's standard-HDF5 subset stands in for it
    from feabas_tpu_torch import _h5lite as h5py

_GCS_PREFIX = 'gs://'
_S3_PREFIX = 's3://'


def parse_file_driver(path):
    """Return (driver, stripped_path); driver in {'file', 'gs', 's3'}."""
    if path.startswith(_GCS_PREFIX):
        return 'gs', path
    if path.startswith(_S3_PREFIX):
        return 's3', path
    if path.startswith('file://'):
        return 'file', path[len('file://'):]
    return 'file', path


def is_cloud_path(path):
    return parse_file_driver(str(path))[0] != 'file'


def join_paths(*args):
    """os.path.join that keeps URL schemes intact and uses '/' for buckets."""
    args = [str(a) for a in args if a is not None]
    if not args:
        return None
    if is_cloud_path(args[0]):
        out = args[0].rstrip('/')
        for a in args[1:]:
            out = out + '/' + str(a).strip('/')
        return out
    return os.path.join(*args)


def expand_dir(path):
    if is_cloud_path(path):
        return path
    return os.path.abspath(os.path.expanduser(path))


def dir_name(path):
    if is_cloud_path(path):
        return path.rsplit('/', 1)[0]
    return os.path.dirname(path)


def base_name(path):
    return str(path).rstrip('/').rsplit('/', 1)[-1]


class _FakeBlob:
    """Local-FS stand-in for google.cloud.storage.Blob (same call surface
    the rest of this module uses). Activated by FEABAS_TPU_FAKE_GCS_ROOT —
    lets zero-egress environments drive every gs:// code path (cloud
    staging, exists caching, H5 temp staging) against a directory tree."""

    def __init__(self, root, bucket, name):
        self.name = name
        self._p = os.path.join(root, bucket, *name.split('/'))

    def exists(self):
        return os.path.isfile(self._p)

    def download_as_bytes(self):
        with open(self._p, 'rb') as f:
            return f.read()

    def upload_from_string(self, data):
        os.makedirs(os.path.dirname(self._p), exist_ok=True)
        if isinstance(data, str):
            data = data.encode()
        tmp = self._p + '.tmp%d' % os.getpid()
        with open(tmp, 'wb') as f:
            f.write(data)
        os.replace(tmp, self._p)

    def delete(self):
        os.remove(self._p)


class _FakeBucket:
    def __init__(self, root, name):
        self._root = root
        self._name = name

    def blob(self, name):
        return _FakeBlob(self._root, self._name, name)

    def list_blobs(self, prefix=''):
        base = os.path.join(self._root, self._name)
        for dirpath, _, files in os.walk(base):
            for fn in files:
                full = os.path.join(dirpath, fn)
                name = os.path.relpath(full, base).replace(os.sep, '/')
                if name.startswith(prefix):
                    yield _FakeBlob(self._root, self._name, name)


class _FakeGCSClient:
    def __init__(self, root):
        self._root = root

    def bucket(self, name):
        return _FakeBucket(self._root, name)


@lru_cache(maxsize=1)
def _gcs_client():
    fake_root = os.environ.get('FEABAS_TPU_FAKE_GCS_ROOT')
    if fake_root:
        return _FakeGCSClient(fake_root)
    from google.cloud import storage as gcs  # noqa: lazy, optional
    return gcs.Client()


def _split_bucket(path):
    rel = path[len(_GCS_PREFIX):]
    bucket, _, blob = rel.partition('/')
    return bucket, blob


def makedirs(path, exist_ok=True):
    if is_cloud_path(path):
        return  # buckets have no directories
    os.makedirs(path, exist_ok=exist_ok)


_exists_cache = {}


def file_exists(path, use_cache=False):
    if path is None:
        return False
    if use_cache and path in _exists_cache:
        return _exists_cache[path]
    driver, p = parse_file_driver(str(path))
    if driver == 'file':
        out = os.path.exists(p)
    elif driver == 'gs':
        bucket, blob = _split_bucket(p)
        out = _gcs_client().bucket(bucket).blob(blob).exists()
    else:
        raise NotImplementedError(f'unsupported driver for {path}')
    if out:  # only cache positives: negatives flip as pipelines progress
        _exists_cache[path] = out
    return out


def clear_exists_cache():
    _exists_cache.clear()


def list_folder_content(pattern, recursive=False):
    """Glob; for buckets the fixed prefix is listed then filtered."""
    driver, p = parse_file_driver(str(pattern))
    if driver == 'file':
        return sorted(_glob.glob(p, recursive=recursive))
    if driver == 'gs':
        bucket_name, blob_pat = _split_bucket(p)
        prefix = re.split(r'[*?\[]', blob_pat, maxsplit=1)[0]
        rx = re.compile(_glob.translate(blob_pat, recursive=True)
                        if hasattr(_glob, 'translate') else
                        _glob.fnmatch.translate(blob_pat))
        names = []
        for blob in _gcs_client().bucket(bucket_name).list_blobs(prefix=prefix):
            if rx.match(blob.name):
                names.append(f'{_GCS_PREFIX}{bucket_name}/{blob.name}')
        return sorted(names)
    raise NotImplementedError(f'unsupported driver for {pattern}')


def remove_file(path):
    driver, p = parse_file_driver(str(path))
    if driver == 'file':
        try:
            os.remove(p)
        except OSError as e:
            if e.errno != errno.ENOENT:
                raise
    elif driver == 'gs':
        bucket, blob = _split_bucket(p)
        b = _gcs_client().bucket(bucket).blob(blob)
        try:
            b.delete()
        except Exception:
            # match the local branch's ENOENT tolerance: the real client
            # raises google NotFound, the fake shim FileNotFoundError
            if b.exists():
                raise
    _exists_cache.pop(path, None)


@contextmanager
def File(path, mode='r', **kwargs):
    """Open local or cloud file. Text modes for yaml/txt, binary for blobs."""
    driver, p = parse_file_driver(str(path))
    if driver == 'file':
        if any(m in mode for m in ('w', 'a', 'x')):
            d = os.path.dirname(p)
            if d:
                os.makedirs(d, exist_ok=True)
        with open(p, mode, **kwargs) as f:
            yield f
    elif driver == 'gs':
        bucket, blob_name = _split_bucket(p)
        blob = _gcs_client().bucket(bucket).blob(blob_name)
        if 'r' in mode:
            data = blob.download_as_bytes()
            import io
            yield io.StringIO(data.decode()) if 'b' not in mode else io.BytesIO(data)
        else:
            import io
            buf = io.StringIO() if 'b' not in mode else io.BytesIO()
            yield buf
            data = buf.getvalue()
            if isinstance(data, str):
                data = data.encode()
            blob.upload_from_string(data)
            _exists_cache.pop(path, None)
    else:
        raise NotImplementedError(f'unsupported driver for {path}')


class H5File:
    """h5py.File wrapper that stages cloud-resident files via local temp."""

    def __init__(self, path, mode='r', **kwargs):
        self._path = str(path)
        self._mode = mode
        self._kwargs = kwargs
        self._tmp = None
        if is_cloud_path(self._path):
            fd, self._tmp = tempfile.mkstemp(suffix='.h5')
            os.close(fd)
            if 'r' in mode or 'a' in mode:
                with File(self._path, 'rb') as fsrc, open(self._tmp, 'wb') as fdst:
                    shutil.copyfileobj(fsrc, fdst)
            self._fh = h5py.File(self._tmp, mode, **kwargs)
        else:
            if any(m in mode for m in ('w', 'a', 'x')):
                d = os.path.dirname(self._path)
                if d:
                    os.makedirs(d, exist_ok=True)
            self._fh = h5py.File(self._path, mode, **kwargs)

    def __enter__(self):
        return self._fh

    def __exit__(self, exc_type, exc, tb):
        self._fh.close()
        if self._tmp is not None:
            try:
                if exc_type is None and any(m in self._mode for m in ('w', 'a', 'x', '+')):
                    with open(self._tmp, 'rb') as fsrc, File(self._path, 'wb') as fdst:
                        shutil.copyfileobj(fsrc, fdst)
            finally:
                os.remove(self._tmp)
        return False

    def close(self):
        self.__exit__(None, None, None)


def load_yaml(path, default=None):
    if (path is None) or (not file_exists(path)):
        return {} if default is None else default
    with File(path, 'r') as f:
        conf = yaml.safe_load(f)
    return conf if conf is not None else ({} if default is None else default)


def save_yaml(path, data):
    with File(path, 'w') as f:
        yaml.safe_dump(data, f, default_flow_style=False)
