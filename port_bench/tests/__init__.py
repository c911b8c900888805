"""CPU tests of the port's benchmark (files named ``test_pbench_*``)."""
