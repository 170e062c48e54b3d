"""The program paths the harness can drive, one module each.

A configuration file names its path (``"path": "<name>"``; without the
key, ``pusch_rx``), and the harness loads ``benchmark/paths/<name>.py``
(``spec.path``).  A path module gives what belongs to one entry of the
program, and the harness (``harness.run_cell``: set-up, the window, the
traced stretch, the result line), the loops of ``load.py`` and the
metrics' readers stay shared:

- ``reference_config(config)``: the plain reference's reading of the
  configuration file (``run.p``);
- ``program_config(config)``: the program's configuration object;
- ``make_pool(ref, traffic, seed, device)``: (pool, truth), the calls made
  from the seed on the device, each pool entry the one argument of a step,
  and what the check needs of each;
- ``steps(cfg, config, sampled)``: the executor's step ``(i, arg) ->
  dict``, the program call and the tensors that go back to the host; with
  ``counting`` set it counts the window's calls in ``n`` and keeps the
  outputs of the ``sampled`` ones in ``kept`` on the device;
- ``verdict(run, steps, pool, truth, sampled, limits)``: after the window,
  ``(numbers {name: (value, limit)}, attempted, failed)``;
- ``layer_spans()``: a context manager that opens the benchmark's spans
  around the path's layers while the traced stretch runs;
- ``work_of(run, layer)``: (least seconds, what bounds it) of a layer's
  work over the traced calls, for a roofline reader;
- ``control(cell, seed, device)``: the control's numbers for one seed
  (``tools/calibrate.py``).

A new path is a new file here plus the entries that use it; no file that
is there changes.
"""
