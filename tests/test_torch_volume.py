"""The port's volume slice against the JAX package's, case by case as in
tests/test_volume.py: the writer, ``VolumeRenderer`` (slab and per-z,
serial and worker batches, resume), ``mip_one_level_tensorstore_3d`` and
``create_thumbnail_tensorstore``, each on both backends the port binds
(tensorstore, and the port's ``_tslite`` put in its place). Without
tensorstore the port writes neuroglancer-precomputed where the JAX test
writes zarr. Rendered volumes agree with the JAX package's within 1 LSB."""

import json
import pickle
import sys

import numpy as np
import pytest
import torch

from feabas_tpu_torch import _tslite

# the GPU host has neither tensorstore nor h5py: there the card tests read
# their volumes with the port's store, and the JAX package's storage gets
# the port's standard-HDF5 subset
try:
    import tensorstore as ts
except ImportError:
    ts = _tslite
try:
    import h5py  # noqa: F401
except ImportError:
    from feabas_tpu_torch import _h5lite
    sys.modules['h5py'] = _h5lite

from feabas_tpu import dal as jdal
from feabas_tpu import mipmap as jmipmap
from feabas_tpu import renderer as jrenderer
from feabas_tpu.common import imwrite as jimwrite
from feabas_tpu.mesh import Mesh as JMesh
from feabas_tpu_torch import config as pconfig
from feabas_tpu_torch import dal as pdal
from feabas_tpu_torch import mipmap as pmipmap
from feabas_tpu_torch import renderer as prenderer
from feabas_tpu_torch import trace as ptrace
from feabas_tpu_torch.common import imread
from feabas_tpu_torch.mesh import Mesh as PMesh

from synthutil import texture

torch.set_num_threads(1)

DRIFT = np.array([[0, 0], [5, -3], [-2, 7], [4, 4]], float)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv('FEABAS_TORCH_DEVICE', 'cpu')
    pconfig.clear_config_caches()
    yield
    pconfig.clear_config_caches()


@pytest.fixture(params=['tensorstore', '_tslite'])
def backend(request, monkeypatch):
    """The store the port opens volumes with; returns the driver the port
    writes where the JAX test writes ``driver``."""
    if request.param == '_tslite':
        monkeypatch.setattr(pdal, 'ts', _tslite)
        return lambda driver: 'neuroglancer_precomputed'
    monkeypatch.setattr(pdal, 'ts', ts)
    return lambda driver: driver


def _read_all(path):
    """The whole volume at ``path`` (x, y, z), read by tensorstore."""
    for marker, driver in (('info', 'neuroglancer_precomputed'),
                           ('.zarray', 'zarr')):
        try:
            d = ts.open({'driver': driver, 'kvstore': {
                'driver': 'file', 'path': str(path)}}).result()
        except ValueError:
            continue
        a = d.read().result()
        return a[..., 0] if a.ndim == 4 else a
    raise AssertionError(f'no volume at {path}')


def _assert_within_one_lsb(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1, (d.max(), (d > 0).mean())


def test_tensorstore_writer_roundtrip(tmp_path, workdir, rng, backend):
    """As the JAX test: one block written and read back, Morton planning,
    the to_dict round trip; the writer pickles without its handle and the
    copy opens the volume without creating it."""
    img = rng.integers(0, 255, (80, 90)).astype(np.uint8)
    out = {}
    for name, mod in (('jax', jdal), ('port', pdal)):
        drv = 'zarr' if name == 'jax' else backend('zarr')
        w = mod.TensorStoreWriter.create(str(tmp_path / name),
                                         (10, 20, 200, 180), 3,
                                         driver=drv, chunk_shape=[64, 64, 1])
        w.write_single_chunk((30, 40, 120, 120), 1, img)
        out[name] = w
    w = out['port']
    assert np.array_equal(w.read_chunk((30, 40, 120, 120), 1), img)
    chunks = w.plan_chunks()
    assert chunks == out['jax'].plan_chunks()
    assert len(chunks) == 3 * 3
    w2 = pdal.TensorStoreWriter.from_dict(w.to_dict())
    assert np.array_equal(w2.read_chunk((30, 40, 120, 120), 1), img)
    w3 = pickle.loads(pickle.dumps(w))
    assert w3._dataset is None and w3._spec['create'] is True
    assert np.array_equal(w3.read_chunk((30, 40, 120, 120), 1), img)
    assert np.array_equal(_read_all(tmp_path / 'port'),
                          _read_all(tmp_path / 'jax'))


def _sections(rng, h=160, w=160):
    base = texture(rng, h + 40, w + 40)
    return [base[20 + int(d[1]):20 + int(d[1]) + h,
                 20 + int(d[0]):20 + int(d[0]) + w] for d in DRIFT]


@pytest.mark.parametrize('device_render', [False, True])
def test_volume_render_and_downsample(tmp_path, workdir, rng, backend,
                                      device_render):
    """4 translated sections into a 2-deep-chunk volume (the slab path) by
    both packages, on the host and through the port's device renderer
    (its plain raster here): within 1 LSB of the JAX package's volume; a
    rerun writes nothing; the mip-1 scale of both within 1 LSB."""
    h = w = 160
    imgs = _sections(rng, h, w)
    vols = {}
    for name, mesh_cls, dal_mod, rmod in (
            ('jax', JMesh, jdal, jrenderer), ('port', PMesh, pdal, prenderer)):
        tform_list, loaders = [], {}
        for z, img in enumerate(imgs):
            sec = f's{z}'
            loaders[sec] = dal_mod.StreamLoader(img)
            mesh = mesh_cls.from_bbox((0, 0, w, h), cartesian=True,
                                      mesh_size=40, name=sec, uid=z)
            mesh.set_translation(DRIFT[z])
            tform_list.append((z, sec, mesh))
        out = str(tmp_path / f'{name}_vol')
        writer = dal_mod.TensorStoreWriter.create(
            out, (0, 0, w + 20, h + 20), 4,
            driver='neuroglancer_precomputed', chunk_shape=[64, 64, 2])
        kw = {} if name == 'jax' else {'device_render': device_render}
        vr = rmod.VolumeRenderer(tform_list, loaders, writer,
                                 flag_dir=str(tmp_path / f'{name}_flags'),
                                 **kw)
        assert vr.render_volume() > 0
        assert vr.render_volume() == 0          # resume: nothing new
        vols[name] = out
    got, want = _read_all(vols['port']), _read_all(vols['jax'])
    _assert_within_one_lsb(got, want)
    ref = got[40:120, 40:120, 0].astype(float).ravel()
    for z in range(1, 4):
        cc = np.corrcoef(ref, got[40:120, 40:120, z].astype(float).ravel())
        assert cc[0, 1] > 0.98, (z, cc)
    ds = {}
    for name, mod in (('jax', jmipmap), ('port', pmipmap)):
        ds[name] = str(tmp_path / f'{name}_ds')
        assert mod.mip_one_level_tensorstore_3d(
            vols[name], ds[name], mip_levels=[1], downsample_z=1) == 1
    _assert_within_one_lsb(_read_all(ds['port']), _read_all(ds['jax']))
    assert _read_all(ds['port']).shape == ((w + 20) // 2, (h + 20) // 2, 4)


@pytest.fixture()
def tile_volume(tmp_path, workdir, rng):
    """4 sections on disk as tiled images + meshes, loadable by workers."""
    h = w = 160
    tform_list, loaders = [], {}
    for z, img in enumerate(_sections(rng, h, w)):
        name = f's{z}'
        sec_dir = tmp_path / name
        jimwrite(str(sec_dir / 'tile.png'), img.astype(np.uint8))
        coord = sec_dir / 'metadata.txt'
        coord.write_text('{ROOT_DIR}\t' + str(sec_dir) + '\n'
                         + f'tile.png\t0\t0\t{w}\t{h}\n')
        loaders[name] = str(coord)
        mesh = JMesh.from_bbox((0, 0, w, h), cartesian=True, mesh_size=40,
                               name=name, uid=z)
        mesh.set_translation(DRIFT[z])
        mesh_path = tmp_path / f'{name}_tform.h5'
        mesh.save_to_h5(str(mesh_path))
        tform_list.append((z, name, str(mesh_path)))
    return tform_list, loaders, (w, h)


def test_volume_render_parallel_workers_resume(tile_volume, tmp_path,
                                               backend):
    """Worker batches (host path): a chunk marked done in a slab's flag
    file is never written; the rest agrees with the JAX package's volume
    within 1 LSB; a full resume writes nothing."""
    tform_list, loaders, (w, h) = tile_volume
    vols = {}
    for name, dal_mod, rmod in (('jax', jdal, jrenderer),
                                ('port', pdal, prenderer)):
        out = str(tmp_path / f'{name}_par')
        writer = dal_mod.TensorStoreWriter.create(
            out, (0, 0, w + 20, h + 20), 4,
            driver='neuroglancer_precomputed', chunk_shape=[64, 64, 2])
        flag_dir = tmp_path / f'{name}_flags'
        flag_dir.mkdir()
        (flag_dir / 'slab00000_flags.json').write_text(
            json.dumps({'done': [[0, 0]]}))
        kw = {} if name == 'jax' else {'device_render': False}
        vr = rmod.VolumeRenderer(tform_list, dict(loaders), writer,
                                 flag_dir=str(flag_dir), **kw)
        assert vr.render_volume(num_workers=2, chunks_per_job=2) > 0
        assert vr.render_volume(num_workers=2, chunks_per_job=2) == 0
        vols[name] = out
    got = _read_all(vols['port'])
    assert not got[0:64, 0:64, 0:2].any()          # the chunk marked done
    assert got[64:128, 0:64, 0].any()
    _assert_within_one_lsb(got, _read_all(vols['jax']))


def test_volume_nearest_interp_preserves_labels(tmp_path, workdir, backend):
    """remap_interp='NEAREST' reaches the resampler (the per-z path: chunks
    one section deep): only source label values, and the JAX package's."""
    h = w = 96
    labels = np.zeros((h, w), np.uint8)
    labels[:, w // 3:2 * w // 3] = 100
    labels[:, 2 * w // 3:] = 200
    vols = {}
    for name, mesh_cls, dal_mod, rmod in (
            ('jax', JMesh, jdal, jrenderer), ('port', PMesh, pdal, prenderer)):
        mesh = mesh_cls.from_bbox((0, 0, w, h), cartesian=True,
                                  mesh_size=32, name='lab', uid=0)
        mesh.set_translation((0.5, 0.5))
        out = str(tmp_path / f'{name}_lab')
        drv = 'zarr' if name == 'jax' else backend('zarr')
        writer = dal_mod.TensorStoreWriter.create(
            out, (0, 0, w, h), 1, driver=drv, chunk_shape=[64, 64, 1])
        vr = rmod.VolumeRenderer([(0, 'lab', mesh)],
                                 {'lab': dal_mod.StreamLoader(labels)},
                                 writer, remap_interp='NEAREST')
        assert vr.render_volume() > 0
        vols[name] = out
    got = _read_all(vols['port'])
    assert set(np.unique(got).tolist()) <= {0, 100, 200}
    assert np.array_equal(got, _read_all(vols['jax']))


def test_volume_slab_single_write_per_chunk(tile_volume, tmp_path,
                                            monkeypatch, backend):
    """On a 4-deep-chunk volume every storage chunk is written exactly once
    (one ``write_slab`` each, no per-z write), and the volume agrees with
    the JAX package's within 1 LSB."""
    tform_list, loaders, (w, h) = tile_volume
    vols = {}
    for name, dal_mod, rmod in (('jax', jdal, jrenderer),
                                ('port', pdal, prenderer)):
        vols[name] = str(tmp_path / f'{name}_slab')
        writer = dal_mod.TensorStoreWriter.create(
            vols[name], (0, 0, w + 20, h + 20), 4,
            driver='neuroglancer_precomputed', chunk_shape=[64, 64, 4])
        if name == 'jax':
            assert rmod.VolumeRenderer(tform_list, dict(loaders),
                                       writer).render_volume() == 9
            continue
        calls = {'slab': 0}
        orig = pdal.TensorStoreWriter.write_slab

        def count(self, *a, **k):
            calls['slab'] += 1
            return orig(self, *a, **k)

        def per_z(self, *a, **k):
            raise AssertionError('per-z write in slab mode')

        monkeypatch.setattr(pdal.TensorStoreWriter, 'write_slab', count)
        monkeypatch.setattr(pdal.TensorStoreWriter, 'write_single_chunk',
                            per_z)
        n = rmod.VolumeRenderer(tform_list, dict(loaders), writer,
                                device_render=False).render_volume()
        assert calls['slab'] == n == len(writer.plan_chunks()) == 9
    _assert_within_one_lsb(_read_all(vols['port']), _read_all(vols['jax']))


def _render_calls(tform_list, loaders, writer, parts, flag_dir=None):
    """``VolumeRenderer`` calls over the sections ``parts`` (slices of
    ``tform_list``) on the host, one after another: [(writes, counters)]
    of each call."""
    out = []
    for part in parts:
        ptrace.reset_counters()
        n = prenderer.VolumeRenderer(tform_list[part], dict(loaders), writer,
                                     flag_dir=flag_dir,
                                     device_render=False).render_volume()
        out.append((n, ptrace.counters()))
    return out


@pytest.mark.parametrize('flags', [False, True])
def test_split_calls_over_a_slab_write_the_whole_calls_volume(
        tile_volume, tmp_path, backend, flags):
    """Calls over sections [0, 2) and [2, 4) of a 4-deep-chunk volume
    write the volume one call over [0, 4) writes, with a flag dir and
    without: each call writes only its own sections' layers of each chunk,
    in writes over part of a chunk's depth (``volume.partial_writes``),
    and the other layers stay as stored; the whole call writes each chunk
    once, whole. With flags, a call over [0, 4) after the call over
    [0, 2) renders only sections 2 and 3, and a resumed call writes
    nothing."""
    tform_list, loaders, (w, h) = tile_volume

    def volume(name, parts):
        out = str(tmp_path / name)
        writer = pdal.TensorStoreWriter.create(
            out, (0, 0, w + 20, h + 20), 4,
            driver='neuroglancer_precomputed', chunk_shape=[64, 64, 4])
        calls = _render_calls(tform_list, loaders, writer, parts,
                              str(tmp_path / f'{name}_flags') if flags
                              else None)
        return _read_all(out), calls

    whole, [(n, c)] = volume('whole', [slice(0, 4)])
    assert n == c['volume.chunk_writes'] == 9
    assert 'volume.partial_writes' not in c
    assert c['volume.layers'] == 36
    split, calls = volume('split', [slice(0, 2), slice(2, 4)])
    for n, c in calls:
        assert n == c['volume.chunk_writes'] == c['volume.partial_writes'] == 9
        assert c['volume.layers'] == 18
    assert whole[..., 2:].any() and np.array_equal(split, whole)
    if not flags:
        return
    later, calls = volume('later', [slice(0, 2), slice(0, 4), slice(0, 4)])
    assert np.array_equal(later, whole)
    (_, first), (n, c), (again, resumed) = calls
    assert n == c['volume.partial_writes'] == 9
    assert c['volume.layers'] == 18              # sections 2 and 3 alone
    assert again == 0 and 'volume.chunk_writes' not in resumed
    with open(tmp_path / 'later_flags' / 'slab00000_flags.json') as f:
        saved = json.load(f)
    assert len(saved['done']) == 9 and saved['layers'] == []


def test_a_call_over_noncontiguous_sections_writes_each_run(
        tile_volume, tmp_path, backend):
    """Sections 0 and 2 of a 4-deep-chunk slab: one write of each, the
    layers of 1 and 3 left as stored; the flags then hold the single
    layers done, and a call over the other two completes the volume."""
    tform_list, loaders, (w, h) = tile_volume
    vols = {}
    for name, parts in (('whole', [slice(0, 4)]),
                        ('steps', [slice(0, 4, 2), slice(1, 4, 2)])):
        out = str(tmp_path / name)
        writer = pdal.TensorStoreWriter.create(
            out, (0, 0, w + 20, h + 20), 4,
            driver='neuroglancer_precomputed', chunk_shape=[64, 64, 4])
        calls = _render_calls(tform_list, loaders, writer, parts,
                              str(tmp_path / f'{name}_flags'))
        vols[name] = _read_all(out)
        if name == 'steps':
            n, c = calls[0]
            assert n == c['volume.chunk_writes'] == 18
            assert c['volume.partial_writes'] == 18
    assert np.array_equal(vols['steps'], vols['whole'])


def test_volume_spans_and_counters(tmp_path, workdir, rng):
    """One slab call records the chunk and write spans, counts each layer
    rendered into a written chunk, its px and the layers no block covered;
    a later call over one section counts its write over part of a chunk's
    depth. Section 1 covers only the first chunk."""
    from torch.profiler import ProfilerActivity, profile
    img = texture(rng, 160, 160).astype(np.uint8)
    tform_list, loaders = [], {}
    for z, side in enumerate((160, 60)):
        loaders[f's{z}'] = pdal.StreamLoader(img[:side, :side])
        tform_list.append((z, f's{z}', PMesh.from_bbox(
            (0, 0, side, side), cartesian=True, mesh_size=40, uid=z)))
    writer = pdal.TensorStoreWriter.create(
        str(tmp_path / 'v'), (0, 0, 160, 160), 2, chunk_shape=[64, 64, 2])
    ptrace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert prenderer.VolumeRenderer(tform_list, dict(loaders), writer,
                                        device_render=False
                                        ).render_volume() == 9
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {'feabas.volume.chunk', 'feabas.volume.write'} <= names
    assert ptrace.counters() == {**ptrace.counters(),
                                 'volume.chunk_writes': 9,
                                 'volume.layers': 10,
                                 'volume.layer_px': 160 * 160 + 64 * 64,
                                 'volume.empty_layers': 8}
    assert 'volume.partial_writes' not in ptrace.counters()
    (n, c), = _render_calls(tform_list, loaders, writer, [slice(1, 2)])
    assert n == c['volume.chunk_writes'] == c['volume.partial_writes'] == 1
    assert c['volume.layers'] == 1 and c['volume.empty_layers'] == 0


def _tsr_workdir(workdir, tile_volume, **tsr):
    """``tile_volume``'s sections and transforms laid out in ``workdir`` as
    the align driver reads them, and its tensorstore_rendering overrides:
    the host route, chunks 4 sections deep, and ``tsr``."""
    import shutil
    tform_list, loaders, (w, h) = tile_volume
    for _, name, mesh_path in tform_list:
        sec = workdir / 'stitched_sections' / 'mip0' / name
        sec.mkdir(parents=True, exist_ok=True)
        shutil.copy(loaders[name], sec / 'metadata.txt')
        (workdir / 'align' / 'tform').mkdir(parents=True, exist_ok=True)
        shutil.copy(mesh_path, workdir / 'align' / 'tform' / (name + '.h5'))
    (workdir / 'configs').mkdir(exist_ok=True)
    conf = {'chunk_shape': [64, 64, 4], 'canvas_bbox': [0, 0, w + 20, h + 20],
            'device_render': False}
    conf.update(tsr)
    (workdir / 'configs' / 'alignment_configs.yaml').write_text(
        json.dumps({'tensorstore_rendering': conf}))
    pconfig.clear_config_caches()


def test_tsr_start_stop_split_writes_the_whole_stacks_volume(
        tile_volume, workdir, tmp_path, backend):
    """``align_main --mode tsr --stop 2`` then ``--start 2`` write the
    volume one call over the stack writes."""
    from feabas_tpu_torch.scripts import align_main
    vols = {}
    for name, calls in (('whole', [[]]),
                        ('split', [['--stop', '2'], ['--start', '2']])):
        vols[name] = str(tmp_path / name)
        _tsr_workdir(workdir, tile_volume, out_dir=vols[name])
        for extra in calls:
            align_main.main(['--mode', 'tsr'] + extra)
    whole = _read_all(vols['whole'])
    assert whole.shape[2] == 4 and whole[..., 3].any()
    assert np.array_equal(_read_all(vols['split']), whole)


def test_tsr_loaders_take_the_tsr_loader_config(tile_volume, workdir,
                                                tmp_path, monkeypatch):
    """``tensorstore_rendering.loader_config`` reaches the loaders that
    ``VolumeRenderer`` renders from, as ``rendering.loader_config`` does
    the rendering stage's."""
    from feabas_tpu_torch.scripts import align_main
    seen = []
    orig = prenderer.VolumeRenderer.__init__

    def spy(self, tform_list, loaders, writer, **kwargs):
        seen.append(loaders)
        orig(self, tform_list, loaders, writer, **kwargs)
    monkeypatch.setattr(prenderer.VolumeRenderer, '__init__', spy)
    _tsr_workdir(workdir, tile_volume, out_dir=str(tmp_path / 'v'),
                 loader_config={'fillval': 7, 'cache_size': 3})
    align_main.main(['--mode', 'tsr', '--stop', '2'])
    (loaders,), = seen,
    assert sorted(loaders) == ['s0', 's1']
    for ld in loaders.values():
        d = ld.to_dict()
        assert (d['fillval'], d['cache_size']) == (7, 3)


def _shaded(rng, h=512, w=512):
    img = texture(rng, h, w).astype(np.float32)
    shade = np.linspace(0.2, 1.0, w)[None, :]
    return np.clip(img * shade, 0, 255).astype(np.uint8)


def test_create_thumbnail_tensorstore(tmp_path, workdir, rng, backend):
    """Thumbnails straight from a volume, plain and highpass, equal to the
    JAX package's on the same image; highpass cancels the shading."""
    h = w = 512
    img = _shaded(rng, h, w)
    paths = {}
    for name, mod in (('jax', jdal), ('port', pdal)):
        drv = 'zarr' if name == 'jax' else backend('zarr')
        paths[name] = str(tmp_path / f'{name}_vol')
        mod.TensorStoreWriter.create(paths[name], (0, 0, w, h), 1,
                                     driver=drv, chunk_shape=[128, 128, 1]
                                     ).write_single_chunk((0, 0, w, h), 0,
                                                          img)
    assert pmipmap.tensorstore_spec_for_dir(paths['port']) is not None
    thumbs = {}
    for hp in (False, True):
        for name, mod in (('jax', jmipmap), ('port', pmipmap)):
            p = str(tmp_path / f'{name}_{hp}.png')
            mod.create_thumbnail_tensorstore(
                paths[name], p, thumbnail_mip=2, highpass=hp,
                highpass_inter_mip=0)
            thumbs[name, hp] = imread(p)
        assert thumbs['port', hp].shape == (h // 4, w // 4)
        assert np.array_equal(thumbs['port', hp], thumbs['jax', hp])

    def lr_ratio(t):
        m = t.astype(float)
        a, b = m[:, :m.shape[1] // 2].mean(), m[:, m.shape[1] // 2:].mean()
        return min(a, b) / max(a, b)

    assert lr_ratio(thumbs['port', True]) > \
        lr_ratio(thumbs['port', False]) + 0.1


@pytest.mark.parametrize('highpass', [False, True])
def test_thumbnail_of_a_precomputed_volume(tmp_path, workdir, rng, backend,
                                           highpass):
    """Reference fault R3: the JAX package's downsample factors have three
    entries, which tensorstore refuses for a (rank-4) precomputed volume;
    the port's cover every dimension and give the JAX package's thumbnail
    of the same image held in zarr."""
    h, w = 256, 384
    img = _shaded(rng, h, w)
    pre, zarr = str(tmp_path / 'pre'), str(tmp_path / 'zarr')
    pdal.TensorStoreWriter.create(pre, (0, 0, w, h), 1,
                                  chunk_shape=[128, 128, 1]
                                  ).write_single_chunk((0, 0, w, h), 0, img)
    jdal.TensorStoreWriter.create(zarr, (0, 0, w, h), 1, driver='zarr',
                                  chunk_shape=[128, 128, 1]
                                  ).write_single_chunk((0, 0, w, h), 0, img)
    with pytest.raises(ValueError, match='rank'):
        jmipmap.create_thumbnail_tensorstore(pre, None, thumbnail_mip=2,
                                             highpass=highpass)
    got = pmipmap.create_thumbnail_tensorstore(pre, None, thumbnail_mip=2,
                                               highpass=highpass)
    want = jmipmap.create_thumbnail_tensorstore(zarr, None, thumbnail_mip=2,
                                                highpass=highpass)
    assert np.array_equal(got, want)


def test_volume_render_from_tensorstore_source(tmp_path, workdir, rng,
                                               backend):
    """A section held in a volume feeds the next stage: its directory
    resolves to a TensorStoreLoader in the serial and the worker path, and
    an identity render gives the section back, as in the JAX package."""
    h = w = 128
    img = texture(rng, h, w).astype(np.uint8)
    src_dir = str(tmp_path / 'src_vol')
    pdal.TensorStoreWriter.create(src_dir, (0, 0, w, h), 1,
                                  driver=backend('zarr'),
                                  chunk_shape=[64, 64, 1]
                                  ).write_single_chunk((0, 0, w, h), 0, img)
    assert isinstance(prenderer.resolve_section_source(src_dir),
                      pdal.TensorStoreLoader)
    mesh = PMesh.from_bbox((0, 0, w, h), cartesian=True, mesh_size=40,
                           name='sec', uid=0)
    mesh_path = str(tmp_path / 'sec.h5')
    mesh.save_to_h5(mesh_path)
    writer = pdal.TensorStoreWriter.create(str(tmp_path / 'out_vol'),
                                           (0, 0, w, h), 1,
                                           driver=backend('zarr'),
                                           chunk_shape=[64, 64, 1])
    vr = prenderer.VolumeRenderer([(0, 'sec', mesh_path)], {'sec': src_dir},
                                  writer, device_render=False)
    assert vr.render_volume(num_workers=2, chunks_per_job=1) > 0
    assert np.array_equal(np.asarray(writer.read_chunk((0, 0, w, h), 0)),
                          img)


# ------------------------------ on the card ------------------------------ #

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    from feabas_tpu_torch import device as device_mod
    return device_mod


@pytest.mark.cuda
def test_tsr_renders_on_the_card(tmp_path, workdir, rng, monkeypatch):
    """Phase 9's (b) on a small stack: ``VolumeRenderer`` with device
    rendering on the card, through ``_tslite``, launches the mesh raster
    and gives the host render's volume within 1 LSB (chip_smoke's
    ``layer_agreement``); a rerun writes nothing."""
    import chip_smoke
    device_mod = _card()
    monkeypatch.setattr(pdal, 'ts', _tslite)
    h = w = 160
    vols = {}
    for dev, flag in (('cpu', False), ('cuda', True)):
        tform_list, loaders = [], {}
        for z, img in enumerate(_sections(np.random.default_rng(7), h, w)):
            sec = f's{z}'
            loaders[sec] = pdal.StreamLoader(img)
            mesh = PMesh.from_bbox((0, 0, w, h), cartesian=True,
                                   mesh_size=40, name=sec, uid=z)
            mesh.set_translation(DRIFT[z])
            tform_list.append((z, sec, mesh))
        vols[dev] = str(tmp_path / dev)
        writer = pdal.TensorStoreWriter.create(
            vols[dev], (0, 0, w + 20, h + 20), 4, chunk_shape=[64, 64, 4])
        vr = prenderer.VolumeRenderer(tform_list, loaders, writer,
                                      flag_dir=str(tmp_path / f'{dev}_f'),
                                      remap_interp='LINEAR',
                                      device_render=flag, device=dev)
        device_mod.reset_launch_counts()
        assert vr.render_volume() == 9
        if dev == 'cuda':
            assert device_mod.launch_counts()['mesh_raster'] > 0
        assert vr.render_volume() == 0
    got, want = _read_all(vols['cuda']), _read_all(vols['cpu'])
    mx, share, _, _ = chip_smoke.layer_agreement(got, want)
    assert mx <= 1, (mx, share)


@pytest.mark.cuda
def test_stitch_volume_renders_on_the_card(tmp_path, workdir, monkeypatch):
    """Phase 9's (a) on a small section: ``render_series_to_tensorstore``
    on the card, through ``_tslite``, launches the montage blend and gives
    the CPU render's volume within 1 LSB."""
    import cv2
    import chip_smoke
    from feabas_tpu_torch import stitcher as pstitcher
    device_mod = _card()
    monkeypatch.setattr(pdal, 'ts', _tslite)
    world = texture(np.random.default_rng(42), 300, 500)
    p0, p1 = str(tmp_path / 'x.png'), str(tmp_path / 'y.png')
    cv2.imwrite(p0, world[:, :300])
    cv2.imwrite(p1, world[:, 200:])
    vols = {}
    for dev in ('cpu', 'cuda'):
        st = pstitcher.Stitcher([p0, p1], [(0, 0, 300, 300),
                                           (200, 0, 500, 300)], device=dev)
        st.initialize_meshes(mesh_sizes=[100])
        for m, bb in zip(st.meshes, st.init_bboxes):
            m.set_translation((bb[0], bb[1]), gear=('INITIAL', 'MOVING'))
        vols[dev] = str(tmp_path / dev)
        device_mod.reset_launch_counts()
        pstitcher.MontageRenderer.from_stitcher(st, device=dev) \
            .render_series_to_tensorstore(vols[dev], read_chunk_size=(64, 64))
        if dev == 'cuda':
            assert device_mod.launch_counts()['montage_blend'] > 0
    mx, share, med, cc = chip_smoke.layer_agreement(_read_all(vols['cuda']),
                                                    _read_all(vols['cpu']))
    assert mx <= 1 and cc > 0.99, (mx, share, cc)


def test_chip_checks_reference_equals_the_store(tmp_path):
    """chip_smoke's numpy reference of the volume checks
    (``block_reduce``) equals ``_tslite``'s downsample views and
    tensorstore's, edge blocks included."""
    import chip_smoke
    rng = np.random.default_rng(5)
    vol = rng.integers(0, 256, (75, 61, 7), dtype=np.uint8)
    spec = {'driver': 'neuroglancer_precomputed',
            'kvstore': {'driver': 'file', 'path': str(tmp_path / 'v')},
            'scale_metadata': {'size': [75, 61, 7], 'chunk_size': [32, 32, 4],
                               'resolution': [4, 4, 30], 'encoding': 'raw'},
            'multiscale_metadata': {'data_type': 'uint8', 'num_channels': 1,
                                    'type': 'image'},
            'create': True, 'open': True}
    _tslite.open(spec).result()[..., 0] = vol
    base = {'driver': 'neuroglancer_precomputed',
            'kvstore': {'driver': 'file', 'path': str(tmp_path / 'v')}}
    for f, method in (((2, 2, 1), 'mean'), ((8, 8, 3), 'mean'),
                      ((4, 4, 1), 'max'), ((4, 4, 2), 'min')):
        want = chip_smoke.block_reduce(vol, f, method)
        for mod in (_tslite, ts):
            got = mod.open({'driver': 'downsample', 'base': base,
                            'downsample_factors': list(f) + [1],
                            'downsample_method': method}).result()[
                ..., 0].read().result()
            assert np.array_equal(got, want), (f, method, mod.__name__)
