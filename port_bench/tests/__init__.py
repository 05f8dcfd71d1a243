"""CPU tests of the benchmark (``python -m pytest port_bench/tests -q``);
the tests marked ``cuda`` run a cell on the card and skip without one."""
