"""PAGE-XML names the port uses (from ``citlab_as_tpu/pagexml/constants.py``)."""

SEPARATORREGION = "SeparatorRegion"
