"""Command line interface: ``bioengine call|apps|cluster|status|worker``.

Replaces ref bioengine/cli/ against the framework's own control plane.
"""
