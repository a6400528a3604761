"""I/O codecs the port reads and writes: MRC, cisTEM binary tables, PDB
coordinates, STAR files (RELION particle, tomogram and ArtiaX stars),
FREALIGN .par files, Warp .tomostar files, EMAN2 HDF stacks and LST
lists, camera movies (TIFF with LZW through the native pypio library,
EER, DM3/DM4), and for tomography SerialEM .mdoc files, IMOD .xf
transforms and point models, and pick coordinate files."""
