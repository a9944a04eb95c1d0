"""The general parts of the benchmark: what finds a cell's files by
name, makes its inputs from the seed, reads the device trace and prints
the result.  Nothing here knows a particular configuration, traffic mix
or metric."""
