"""The benchmark's general machinery: the manifest and the files a cell is
made of, the data, the measured window, the trace and its reduction, the
roofline arithmetic, the comparison that decides `correct`, and the import
guard. Nothing here belongs to one configuration, traffic kind or metric:
those live in their own files under ``perfbench/`` and are found by name.
"""
