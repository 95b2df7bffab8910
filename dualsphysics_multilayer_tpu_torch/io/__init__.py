"""Run output on the host: the .bi4 container (``jbinary``), PART files
(``partdata``), the floating-body, excluded-particle and run-head channels
(``floatdata``), mDBC normals (``extradata``), VTK (``vtkout``) and the
output manager with restart (``output``).  numpy only, apart from one copy
to the host per array at save time."""
