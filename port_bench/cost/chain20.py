"""The frozen work of one member-step of ``chain20``'s step kernel (K1):
the semiseparable 20-link chain, iterations (2, 0), Kahan compensation,
float32, 50 steps a launch, as the program's
``utils.roofline.fused_step_cost`` counted it at commit 26c99f2 (a
transcendental counted as one operation; the state read and written once a
launch).  Frozen here so that a change to the program's forms cannot change
the yardstick; ``test_port_bench_cost.py`` pins it."""

FLOPS_PER_MEMBER_STEP = 3729.4
TRANSCENDENTALS_PER_MEMBER_STEP = 61.2
OPS_PER_MEMBER_STEP = FLOPS_PER_MEMBER_STEP + TRANSCENDENTALS_PER_MEMBER_STEP
BYTES_PER_MEMBER_STEP = 19.2
DTYPE = "float32"
