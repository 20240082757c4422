"""The benchmark's general code: the cell's files found by name
(``spec``), seeded weights and inputs made on the device (``weights``,
``feed``), the device trace and its reduction (``trace``), the comparison
that decides ``correct`` (``compare``) and the run itself (``runner``)."""
