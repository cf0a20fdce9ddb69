"""Evaluation of the port: the baseline and article-separation (AS) measure."""
