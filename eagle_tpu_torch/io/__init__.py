"""Host-side I/O: the JSON output files (:mod:`.output`) and the video
decode / encode (:mod:`.video`, OpenCV, imported only when called)."""
