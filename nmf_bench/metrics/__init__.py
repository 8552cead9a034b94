"""One reader a metric: ``read(run)`` takes the run's record and returns
the metric's value, or None where the run has nothing for it to read.

The record holds ``setup_s``, ``window_s`` (host clock), ``units``,
``least_s`` (``work.py``), and what the driver and the trace add:
``iterations`` or ``sweeps``, ``spans`` (the program's stage seconds a
unit), ``busy_s`` and ``trace_window_s`` (device trace) and
``window_peak_bytes``. A reader named ``<name>.py`` serves the metric of
that name; ``<base>.py`` serves ``<base>.<cells>``, a quantity split by the
end-to-end metric it moves.
"""
