"""The kinds of traffic mix, one module each, found by a mix's `kind`
(`harness.load_loop`). Each gives `run(r)`, which drives the cell's program
through set-up, the window and the judging and returns `harness.report`'s
dict; `make_program(r)`, the port through its normal entry; and
`make_control(r, prec)`, the reference at a lower precision in the
program's place (for `calibrate.py` and the tests, never a benchmark run).
`r` carries the cell, seed, seconds, trace flag, device, set-up marks, the
reference detector and the seeded weights (`harness.run`)."""
