"""LatticeUrbanWind-TPU: an urban micrometeorology LES framework in JAX.

Clean-room JAX implementation of the capabilities of the reference
LatticeUrbanWind platform: mesoscale-NWP-coupled lattice-Boltzmann LES over
voxelized city geometry, with the same deck/config contract, file formats,
and run modes.  The step runs as XLA-fused jnp or as one fused GPU kernel
(Pallas, Triton route), with 16-bit DDF storage and fp32 arithmetic; an
`n_gpu` split shards the lattice over a device mesh.
"""

__version__ = "0.2.0"
