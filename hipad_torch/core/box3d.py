"""3D box state layout (constants of ``hipad_tpu/core/box3d.py``).

The undecoded 11-dim box state is

    [x, y, z, log(w), log(l), log(h), sin(yaw), cos(yaw), vx, vy, vz]

and the quality channels are (centerness, yawness).
"""

X, Y, Z, W, L, H, SIN_YAW, COS_YAW, VX, VY, VZ = range(11)
STATE_DIM = 11

# Quality indices.
CNS, YNS = 0, 1

# Decoded box: yaw angle index.
YAW = 6
