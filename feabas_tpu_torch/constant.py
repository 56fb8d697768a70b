"""Shared enumerations and numeric defaults.

Values mirror the reference implementation (``feabas/constant.py``) so that
HDF5 artifacts written by either framework are interchangeable.

The port's copy of ``feabas_tpu/constant.py``, cut to what the port reaches.
"""

# simplification strategies for spatial.Geometry
# Boundary-simplification strategies (reference: spatial.py:864-897).
# This package's raster Geometry decomposes region boundaries into a
# SHARED arc graph and simplifies each arc once (spatial.label_boundary_
# arcs + simplify_arcs) — i.e. every strategy resolves to the topology-
# sharing behavior the reference's SEGMENT/GEOM_COLLECTION modes exist
# to guarantee: adjacent regions can never disagree about a common
# border, and no sliver gaps appear. The constants are kept for config/
# API compatibility; they select nothing because the non-sharing modes
# (REGION) would only reintroduce the slivers.
SPATIAL_SIMPLIFY_REGION = 0
SPATIAL_SIMPLIFY_GROUP = 1
SPATIAL_SIMPLIFY_SEGMENT = 2
SPATIAL_SIMPLIFY_GEOM_COLLECTION = 3

# mesh "gears": coordinate states a Mesh carries simultaneously
MESH_GEAR_INITIAL = -1   # resting state as constructed
MESH_GEAR_FIXED = 0      # anchored reference state
MESH_GEAR_MOVING = 1     # current working deformation
MESH_GEAR_STAGING = 2    # candidate deformation pre-validation
MESH_GEARS = (MESH_GEAR_INITIAL, MESH_GEAR_FIXED, MESH_GEAR_MOVING, MESH_GEAR_STAGING)

# triangle-finder policy when deformed triangles overlap
MESH_TRIFINDER_WHATEVER = 0
MESH_TRIFINDER_LEAST_DEFORM = 1
MESH_TRIFINDER_INNERMOST = 2
TRIFINDER_MODE_LIST = ('WHATEVER', 'LEAST_DEFORM', 'INNERMOST')

# render approximation levels
RENDER_LOCAL_RIGID = 0
RENDER_LOCAL_AFFINE = 1
RENDER_CONTIGEOUS = 2
RENDER_FULL = 3

# blending of overlapping source tiles during montage rendering
BLEND_NONE = 0
BLEND_MAX = 1
BLEND_LINEAR = 2

# annealing modes: how FIXED gear is rebased onto MOVING
ANNEAL_GLOBAL_RIGID = 0
ANNEAL_GLOBAL_AFFINE = 1
ANNEAL_CONNECTED_RIGID = 2
ANNEAL_CONNECTED_AFFINE = 3
ANNEAL_COPY_EXACT = 4

# material constitutive models
MATERIAL_MODEL_ENG = 0   # engineering (linear) strain & stress
MATERIAL_MODEL_SVK = 1   # St. Venant-Kirchhoff
MATERIAL_MODEL_NHK = 2   # Neo-Hookean
MATERIAL_MODEL_LIST = ('MATERIAL_MODEL_ENG', 'MATERIAL_MODEL_SVK', 'MATERIAL_MODEL_NHK')

# confidence estimators for FFT cross-correlation
FFT_CONF_NONE = 0
FFT_CONF_STD = 1
FFT_CONF_MIRROR = 2

DEFAULT_RESOLUTION = 4.0   # nm / pixel at mip0
DEFAULT_THICKNESS = 30.0   # nm section thickness
EPSILON0 = 1e-5
