"""The benchmark's yardstick: finding a cell's pieces, traffic, spans and
trace reading, peaks, the comparison and the run."""
