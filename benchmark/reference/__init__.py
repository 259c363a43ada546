"""The benchmark's plain reference of a frame: plain PyTorch, independent of
the program under test.

Each module is a frozen copy of the port's plain code at commit e647ccc
(``geodesic_raytracing_tpu_torch``), trimmed to what the benchmark's
configurations use, so that a later change to the program is held to the
frame as that commit's plain path computes it.  Nothing here imports the
program, JAX or the JAX package, and nothing takes an object the program
made: the reference builds its own sky atlas, camera, launch states, kill
masks and refine budget from the configuration, the seed's inputs and the
number of frames the stream rendered.
"""
