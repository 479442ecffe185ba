"""The served systems the benchmark drives, one module per system.

A configuration file names its system (``"system": "space"``), and
``harness.system(cfg)`` loads ``systems/<system>.py`` by its file path, as
it loads metric readers, so that a new system is a new file. A module
has three functions:

``build(cfg, ref, traffic, seed, device)``
    Builds the system under test from the seed (weights, inputs,
    warm-up: all of set-up) and returns it. The object offers

    - ``submit(k, due, tail=False) -> harness.Req``: request ``k`` of the
      traffic, due at host time ``due``; ``tail`` marks the ragged tail
      a closed loop submits after the window;
    - ``reqs``: ``{rid: harness.Req}`` of every request submitted, each
      given its ``answered`` time (``time.monotonic()``) when its answer
      is ready, and ``dispatched``, ``rec_idx``, ``row``, ``rung`` where
      the system has them;
    - ``on_answers``: None, or a callable ``(n, t)`` the system calls
      whenever ``n`` answers became ready at ``t`` (the closed loop
      submits the next requests from it);
    - ``deadline_s``: the answer's deadline;
    - ``start()`` and ``stop()``: start serving, and stop after every
      submitted request is answered;
    - ``outputs() -> {rid: {output: array}}``: the answers;
    - ``release()``: drops the program's objects, so that the check runs
      after the program's state is freed;
    - ``trace_hooks() -> devtrace.Hooks``: what a traced run wraps in
      spans and which dispatch records it slices.

``compare(cfg, ref, seed, device, reqs, outputs) -> (numbers, demoted)``
    ``numbers`` is ``{name: [value, limit]}`` for every number compared,
    the run correct when no value passes its limit (``check.passed``);
    ``demoted`` names the reference layers that ran at fp32 instead of
    the configuration's precision (empty where there is no such gate).

``control(cfg, ref, seed, device, picked) -> {name: value}``
    The control's readings on the sampled requests ``picked``, by the
    same numbers as ``compare``: the reference in the precision below the
    configuration's, in the program's place.

A system module imports what it serves from the program; nothing under
``bench/`` imports JAX or the JAX package.
"""
