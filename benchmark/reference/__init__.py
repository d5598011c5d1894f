"""The benchmark's plain reference of one dense stereo frame.

Copies of the port's plain PyTorch and NumPy code, frozen when the
benchmark was written, so that a later change of the program cannot move
the yardstick: rectification from the rig, census, the c2f coarse pass and
windows, SGM and WTA (the plain versions of K1-K4), postprocess,
triangulation, the z-gap components (the plain K7), the plane, the .xyzC
export and the debug renders.  Nothing here imports the program or JAX.
"""
