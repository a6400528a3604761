"""I/O codecs the port reads and writes: MRC and cisTEM binary tables."""
