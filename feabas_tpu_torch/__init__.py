"""feabas_tpu_torch: the PyTorch + CUDA port of feabas_tpu.

Mirrors the JAX package module by module and stands alone: it imports
nothing of ``feabas_tpu`` and nothing of jax. The host modules it needs
(constant, storage, config, logging, caching, concurrent, common, spatial,
triangulation, native, material, mesh, dal, multisem, mipmap, renderer,
utils) are its own copies of the JAX package's, under the same file
names; the work-dir files they write are interchangeable with the JAX
package's. Where h5py is missing, ``storage`` reads and writes standard
HDF5 through the port's ``_h5lite``.

Entry points compute on the CUDA card unless the caller asks for the CPU
(``FEABAS_TORCH_DEVICE=cpu`` or a ``device`` argument; see ``device``).
"""

__version__ = '0.1.0'
