"""The plain reference of the benchmark's cells.

Plain PyTorch, written from MuLUT's published algorithm (its
`sr/4_test_lut.py`, `sr/2_transfer_to_lut.py` and `sr/model.py` SRNets):
each rotation rotates the image and pads it at the bottom and right, as
the reference does, and the simplex weights come from a sort of the four
fractions.  It takes the units from `bench_gpu/weights.py` (the npz, or
drawn from the seed) and imports nothing of the program.  Float32
matmuls run with TF32 off (`common.exact_f32`).

`reference/<kind>.py`, one per configuration kind, gives:

- `Reference(cfg, seed, root, device)`: `outputs(frames)` of a (B, H, W,
  3) uint8 host batch as the (B, H*s, W*s, 3) uint8 host array, and
  `state_readings(program_state)`, the numbers that compare what the
  program's set-up derived (`{}` where it derives nothing to compare);
- `Control`: the reference at the next precision down, built and driven
  as an entry's runner (`entries/`), in the program's place.
"""
