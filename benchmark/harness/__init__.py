"""The benchmark's machinery: cells found by name, traffic made from data
files, the device block read from the profiler's trace, the result line
checked before it is printed."""
