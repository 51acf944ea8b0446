"""LUW Studio — the framework's GUI layer.

The reference ships a Qt6/VTK9 desktop application (reference: gui/src/,
MainWindow.cpp + ~25 kLoC) that edits decks against the shared schema, runs
the pipeline scripts with console/progress forwarding, and views VTK
results.  This analog keeps the same roles but is a zero-dependency local
web app (stdlib http.server + one HTML page): accelerator hosts are
headless, so a
browser UI is the native equivalent of a desktop shell.

Start with `luwstudio [case_dir]` and open the printed URL.
"""

from .server import main  # noqa: F401
