"""Material models for the finite-element meshes.

A `Material` carries the mechanical parameters of one mask label: model type
(linear engineering / St. Venant-Kirchhoff / Neo-Hookean), stiffness
multiplier, Poisson ratio, and an optional nonlinear stiffness-vs-area-
stretch curve. `MaterialTable` maps names and mask labels to materials
(capability parity with reference ``feabas/material.py``; the element math
itself lives on device in ``feabas_tpu_torch.ops.fem``).

The port's copy of ``feabas_tpu/material.py``, cut to what the port reaches.
"""

import numpy as np

from feabas_tpu_torch import constant as const
from feabas_tpu_torch import storage
from feabas_tpu_torch.common import func_to_str, str_to_func

# number of knots used when sampling nonlinear stiffness curves for device
STIFFNESS_CURVE_KNOTS = 16
# area-stretch range the sampled curve covers (J outside is clamped)
STIFFNESS_CURVE_RANGE = (0.0, 4.0)


def asymmetrical_elasticity(strain=(0.0, 0.75, 1.0, 1.01),
                            stiffness=(1.5, 1.0, 0.5, 1.0e-7)):
    """Factory for wrinkle-like behavior: soft in expansion, stiff in
    compression. Returns f(J) -> multiplier via linear interpolation
    (reference: feabas/material.py:547)."""
    strain = np.asarray(strain, dtype=np.float64)
    stiffness = np.asarray(stiffness, dtype=np.float64)

    def func(J):
        J = np.asarray(J, dtype=np.float64)
        return np.interp(J, strain, stiffness, left=stiffness[0], right=stiffness[-1])
    func.breakpoints = (strain, stiffness)  # exact knots for device interp
    return func


class Material:
    def __init__(self, **kwargs):
        self.enable_mesh = bool(kwargs.get('enable_mesh', True))
        self.area_constraint = float(kwargs.get('area_constraint', 1.0))
        self.render = bool(kwargs.get('render', True))
        self.render_weight = float(kwargs.get('render_weight', 1.0))
        self.stiffness_multiplier = float(kwargs.get('stiffness_multiplier', 1.0))
        self.poisson_ratio = float(kwargs.get('poisson_ratio', 0.0))
        self.mask_label = kwargs.get('mask_label', None)
        mtype = kwargs.get('type', const.MATERIAL_MODEL_ENG)
        if isinstance(mtype, str):
            mtype = const.MATERIAL_MODEL_LIST.index(mtype.upper()
                     if mtype.upper().startswith('MATERIAL') else f'MATERIAL_MODEL_{mtype.upper()}')
        self.type = int(mtype)
        self.uid = kwargs.get('uid', None)
        self._stiffness_func_factory = kwargs.get('stiffness_func_factory', None)
        self._stiffness_func_params = kwargs.get('stiffness_func_params', {}) or {}
        self._stiffness_func = None
        if self._stiffness_func_factory:
            factory = str_to_func(self._stiffness_func_factory)
            self._stiffness_func = factory(**self._stiffness_func_params)

    @property
    def is_linear(self):
        return (self.type == const.MATERIAL_MODEL_ENG) and (self._stiffness_func is None)

    @property
    def stiffness_func(self):
        return self._stiffness_func

    def stiffness_curve_knots(self,
                              rng=STIFFNESS_CURVE_RANGE,
                              num=STIFFNESS_CURVE_KNOTS):
        """Knots (x, y) for device piecewise-linear interpolation of the
        nonlinear stiffness curve; None when the material is J-independent.
        Uses the factory's exact breakpoints when exposed (padded to ``num``
        by repeating the last knot); otherwise densely samples ``rng``."""
        if self._stiffness_func is None:
            return None
        bp = getattr(self._stiffness_func, 'breakpoints', None)
        if bp is not None and len(bp[0]) <= num:
            x = np.asarray(bp[0], dtype=np.float32)
            y = np.asarray(bp[1], dtype=np.float32)
            if x.size < num:  # pad monotonically so jnp.interp stays valid
                extra = x[-1] + np.arange(1, num - x.size + 1, dtype=np.float32)
                x = np.concatenate([x, extra])
                y = np.concatenate([y, np.full(extra.shape, y[-1], np.float32)])
            return x, y
        x = np.linspace(rng[0], rng[1], max(num, 256))
        return x.astype(np.float32), np.asarray(
            self._stiffness_func(x), dtype=np.float32)

    def to_dict(self):
        return {
            'enable_mesh': self.enable_mesh,
            'area_constraint': self.area_constraint,
            'render': self.render,
            'render_weight': self.render_weight,
            'stiffness_multiplier': self.stiffness_multiplier,
            'poisson_ratio': self.poisson_ratio,
            'mask_label': self.mask_label,
            'type': const.MATERIAL_MODEL_LIST[self.type],
            'uid': self.uid,
            'stiffness_func_factory': func_to_str(self._stiffness_func_factory)
                if not isinstance(self._stiffness_func_factory, (str, type(None)))
                else self._stiffness_func_factory,
            'stiffness_func_params': self._stiffness_func_params,
        }


class MaterialTable:
    """Named materials with unique uids and mask labels.

    Reserved entries: 'default' (uid 0, label 0) and 'exclude' (uid -1,
    label 255) always exist (reference: feabas/material.py:323-446).
    """

    def __init__(self, table=None):
        self._table = {}
        self._next_uid = 1
        self.add('default', Material(uid=0, mask_label=0))
        self.add('exclude', Material(uid=-1, mask_label=255, enable_mesh=False,
                                     render=False))
        if table:
            for name, mat in table.items():
                self.add(name, mat)

    def add(self, name, mat, force_update=True):
        if isinstance(mat, dict):
            mat = Material(**mat)
        if name in self._table and not force_update:
            return False
        if mat.uid is None:
            mat.uid = self._next_uid
        self._next_uid = max(self._next_uid, int(mat.uid) + 1)
        self._table[name] = mat
        return True

    def __getitem__(self, key):
        if key in self._table:
            return self._table[key]
        # fall through: look up by uid
        for mat in self._table.values():
            if mat.uid == key:
                return mat
        raise KeyError(key)

    def __contains__(self, name):
        return name in self._table

    def __iter__(self):
        return iter(self._table.items())

    def uid_to_material(self):
        return {m.uid: m for m in self._table.values()}

    def label_to_uid(self):
        return {m.mask_label: m.uid for m in self._table.values()
                if m.mask_label is not None}

    @classmethod
    def from_pickleable(cls, spec):
        """Build from a dict, a YAML/JSON path, or bytes."""
        if isinstance(spec, (str,)) and (spec.endswith('.yaml') or spec.endswith('.yml')
                                         or spec.endswith('.json')):
            data = storage.load_yaml(spec)
        elif isinstance(spec, (bytes, np.ndarray)):
            import json
            from feabas_tpu_torch.common import numpy_to_str_ascii
            data = json.loads(numpy_to_str_ascii(spec))
        elif isinstance(spec, str):
            import json
            data = json.loads(spec)
        else:
            data = dict(spec)
        tbl = cls()
        for name, mdef in data.items():
            if name in ('default', 'exclude'):
                base = tbl[name].to_dict()
                base.update(mdef or {})
                base['uid'] = tbl[name].uid
                tbl._table[name] = Material(**base)
            else:
                tbl.add(name, Material(**(mdef or {})))
        return tbl

    def copy(self):
        """Deep copy preserving uids (to_dict round-trips reassign them)."""
        import copy as _copy
        new = MaterialTable.__new__(MaterialTable)
        new._table = {n: _copy.deepcopy(m) for n, m in self._table.items()}
        new._next_uid = self._next_uid
        return new

    def to_pickleable(self):
        return {name: m.to_dict() for name, m in self._table.items()}

    def to_json(self):
        import json
        return json.dumps(self.to_pickleable())

    def combine_material_table(self, other, force_update=False, check_label=True):
        labels = set(self.label_to_uid().keys()) if check_label else set()
        for name, mat in other:
            if name in self._table and not force_update:
                continue
            if check_label and (mat.mask_label in labels) and (name not in self._table):
                continue
            d = mat.to_dict()
            d['uid'] = None if name not in ('default', 'exclude') else self[name].uid
            self.add(name, Material(**d), force_update=True)

