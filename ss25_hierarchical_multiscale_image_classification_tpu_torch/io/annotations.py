"""ASAP annotation XML: parsing and writing.

Counterpart of the JAX package's ``io/annotations.py`` on the standard
library's ``xml.etree.ElementTree``, because the card's machine has no
lxml. The polygons are the JAX package's in both directions:

- the JAX parser takes the XPath ``//Annotation/Coordinates |
  //Annotations/Annotation/Coordinates``, a node set in document order
  without duplicates; the second branch is a subset of the first, so the
  node set is every ``Coordinates`` element whose parent is an
  ``Annotation``, in document order, which is what :func:`_coordinate_nodes`
  walks;
- an unparseable coordinate is skipped with a warning, and a syntactically
  invalid file gives ``[]`` (ElementTree raises ``ParseError`` where lxml
  raises ``XMLSyntaxError``);
- the writer's bytes differ from lxml's (ElementTree writes ``" />"`` and
  its own indentation and declaration); the polygons each package parses
  from the other's file are equal.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Sequence

import numpy as np

from ss25_hierarchical_multiscale_image_classification_tpu_torch.logging_utils import (
    get_logger,
)

log = get_logger("io.annotations")


def _coordinate_nodes(root: ET.Element) -> list[ET.Element]:
    """``//Annotation/Coordinates`` in document order."""
    parent = {child: node for node in root.iter() for child in node}
    return [node for node in root.iter("Coordinates")
            if node in parent and parent[node].tag == "Annotation"]


def parse_annotation_xml(xml_path: str) -> list[np.ndarray]:
    """Parse an ASAP annotation XML into level-0 polygons: a list of (K, 2)
    float64 arrays of (X, Y) vertices in annotation order. Unparseable
    coordinates are skipped with a warning; a syntactically invalid file
    returns an empty list."""
    try:
        tree = ET.parse(xml_path)
    except ET.ParseError as e:
        log.error("Error parsing XML file %s: %s", xml_path, e)
        return []

    polygons: list[np.ndarray] = []
    for coordinates_node in _coordinate_nodes(tree.getroot()):
        coords = []
        for coord_node in coordinates_node.findall("Coordinate"):
            try:
                x = float(coord_node.get("X"))
                y = float(coord_node.get("Y"))
            except (ValueError, TypeError) as e:
                log.warning(
                    "Could not parse coordinate (X,Y) from %s: %s", xml_path, e
                )
                continue
            coords.append((x, y))
        if coords:
            polygons.append(np.asarray(coords, dtype=np.float64))
    return polygons


def write_annotation_xml(
    xml_path: str,
    polygons: Sequence[np.ndarray],
    group: str = "Tumor",
) -> None:
    """Write polygons as an ASAP-format annotation XML (fixture generator):
    the JAX writer's elements, attributes and ``%.4f`` coordinates."""
    root = ET.Element("ASAP_Annotations")
    annotations = ET.SubElement(root, "Annotations")
    for i, poly in enumerate(polygons):
        ann = ET.SubElement(
            annotations,
            "Annotation",
            Name=f"Annotation {i}",
            Type="Polygon",
            PartOfGroup=group,
            Color="#F4FA58",
        )
        coords = ET.SubElement(ann, "Coordinates")
        for order, (x, y) in enumerate(np.asarray(poly, dtype=np.float64)):
            ET.SubElement(
                coords,
                "Coordinate",
                Order=str(order),
                X=f"{x:.4f}",
                Y=f"{y:.4f}",
            )
    groups = ET.SubElement(root, "AnnotationGroups")
    ET.SubElement(
        groups, "Group", Name=group, PartOfGroup="None", Color="#F4FA58"
    )
    os.makedirs(os.path.dirname(xml_path) or ".", exist_ok=True)
    tree = ET.ElementTree(root)
    ET.indent(tree)
    tree.write(xml_path, xml_declaration=True, encoding="utf-8")
