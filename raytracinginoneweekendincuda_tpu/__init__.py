"""Differentiable path tracer for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
eazuooz/RayTracinginOneWeekendinCUDA ("Ray Tracing in One Weekend" book 1
complete + "The Next Week" ch. 2-10): spheres / moving spheres / quads /
instanced boxes / constant-density media, Lambertian / Metal / Dielectric /
DiffuseLight / Isotropic materials, solid / checker / image / Perlin-marble
textures, BVH, thin-lens + motion-blur camera, and a 50-bounce iterative
path integrator — re-architected as SoA scene tables + batched wavefront
tracing instead of device-side object graphs with virtual dispatch.
"""

__version__ = "0.1.0"
