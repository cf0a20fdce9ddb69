"""PAGE-XML data model (reference: python_util/parser/xml/page/).

DOM-backed (``xml.etree.ElementTree``; the JAX package uses lxml) so unknown elements round-trip untouched; the file contract
— namespaces, custom-attribute CSS syntax, region/line/word nesting — matches
the reference so its PAGE-XML outputs interoperate with ours.
"""
from citlab_as_tpu_torch.pagexml.page import Page, Metadata
from citlab_as_tpu_torch.pagexml.objects import (
    Points, Region, TextRegion, SeparatorRegion, ImageRegion, GraphicRegion,
    TableRegion, AdvertRegion, NoiseRegion, UnknownRegion, ChartRegion,
    LineDrawingRegion, MathsRegion, ChemRegion, MusicRegion,
    TextLine, Word, REGIONS_DICT,
)
from citlab_as_tpu_torch.pagexml import constants

__all__ = [
    "Page", "Metadata", "Points", "Region", "TextRegion", "SeparatorRegion",
    "ImageRegion", "GraphicRegion", "TableRegion", "AdvertRegion",
    "NoiseRegion", "UnknownRegion", "ChartRegion", "LineDrawingRegion",
    "MathsRegion", "ChemRegion", "MusicRegion", "TextLine", "Word",
    "REGIONS_DICT", "constants",
]
