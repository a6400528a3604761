"""I/O codecs the port reads and writes: MRC, cisTEM binary tables, PDB
coordinates, RELION STAR tables (read only), and for tomography SerialEM
.mdoc files, IMOD .xf transforms and point models, and pick coordinate
files."""
