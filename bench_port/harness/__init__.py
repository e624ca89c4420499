"""The benchmark's machinery: finding a cell's files by name (``spec``),
driving the port (``drive``), reading the profiler's trace (``trace``),
the roofline arithmetic (``roofline``) and the output check (``check``)."""
