"""I/O codecs the port reads and writes: MRC, cisTEM binary tables, PDB
coordinates and RELION STAR tables (read only)."""
