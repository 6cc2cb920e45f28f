"""The benchmark's own library: finding cells by name, drawing a query
stream from a traffic file, the window's arithmetic, the comparison that
decides ``correct``, and the reading of the profiler's trace.

Nothing here imports the program at module level: ``cell.run`` imports
``supersonic_tpu_torch`` when a run starts, and the reference
(``benchmark/reference``) never does.
"""
