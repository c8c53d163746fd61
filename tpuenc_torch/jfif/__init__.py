"""jfif subpackage (copies of tpuenc.jfif)."""
