# Generated by `python -m mosaic_tpu_torch.tools.generate_r_bindings` — do not edit.
# reticulate-backed R bindings over the mosaic_tpu_torch function registry
# (reference analog: R/sparkR-mosaic + R/sparklyr-mosaic, generated from
# the Scala DSL signatures by R/generate_R_bindings.R).

#' @import reticulate
.mosaic_env <- new.env(parent = emptyenv())

#' Enable mosaic_tpu_torch (builds the process context)
#' @param index_system "H3", "BNG" or "CUSTOM(...)"
#' @export
enableMosaic <- function(index_system = "H3") {
  mt <- reticulate::import("mosaic_tpu_torch")
  .mosaic_env$ctx <- mt$MosaicContext$build(index_system)
  .mosaic_env$fns <- .mosaic_env$ctx$register()
  invisible(.mosaic_env$ctx)
}

.mosaic_call <- function(name, ...) {
  if (is.null(.mosaic_env$fns)) enableMosaic()
  do.call(.mosaic_env$fns[[name]], list(...))
}

#' as_hex (generated binding)
#' @export
as_hex <- function(geom) {
  .mosaic_call("as_hex", geom)
}

#' as_json (generated binding)
#' @export
as_json <- function(geom) {
  .mosaic_call("as_json", geom)
}

#' convert_to (generated binding)
#' @export
convert_to <- function(geom, fmt) {
  .mosaic_call("convert_to", geom, fmt)
}

#' convert_to_coords (generated binding)
#' @export
convert_to_coords <- function(geom) {
  .mosaic_call("convert_to_coords", geom)
}

#' convert_to_geojson (generated binding)
#' @export
convert_to_geojson <- function(geom) {
  .mosaic_call("convert_to_geojson", geom)
}

#' convert_to_hex (generated binding)
#' @export
convert_to_hex <- function(geom) {
  .mosaic_call("convert_to_hex", geom)
}

#' convert_to_wkb (generated binding)
#' @export
convert_to_wkb <- function(geom) {
  .mosaic_call("convert_to_wkb", geom)
}

#' convert_to_wkt (generated binding)
#' @export
convert_to_wkt <- function(geom) {
  .mosaic_call("convert_to_wkt", geom)
}

#' flatten_polygons (generated binding)
#' @export
flatten_polygons <- function(geom) {
  .mosaic_call("flatten_polygons", geom)
}

#' grid_boundary (generated binding)
#' @export
grid_boundary <- function(cells, fmt = "wkt", index = NULL) {
  .mosaic_call("grid_boundary", cells, fmt, index)
}

#' grid_boundaryaswkb (generated binding)
#' @export
grid_boundaryaswkb <- function(cells, index = NULL) {
  .mosaic_call("grid_boundaryaswkb", cells, index)
}

#' grid_cell_center (generated binding)
#' @export
grid_cell_center <- function(cells, index = NULL) {
  .mosaic_call("grid_cell_center", cells, index)
}

#' grid_cellkloop (generated binding)
#' @export
grid_cellkloop <- function(cells, k, index = NULL) {
  .mosaic_call("grid_cellkloop", cells, k, index)
}

#' grid_cellkloopexplode (generated binding)
#' @export
grid_cellkloopexplode <- function(cells, k, index = NULL) {
  .mosaic_call("grid_cellkloopexplode", cells, k, index)
}

#' grid_cellkring (generated binding)
#' @export
grid_cellkring <- function(cells, k, index = NULL) {
  .mosaic_call("grid_cellkring", cells, k, index)
}

#' grid_cellkringexplode (generated binding)
#' @export
grid_cellkringexplode <- function(cells, k, index = NULL) {
  .mosaic_call("grid_cellkringexplode", cells, k, index)
}

#' grid_distance (generated binding)
#' @export
grid_distance <- function(cells_a, cells_b, index = NULL) {
  .mosaic_call("grid_distance", cells_a, cells_b, index)
}

#' grid_format_cellid (generated binding)
#' @export
grid_format_cellid <- function(cells, index = NULL) {
  .mosaic_call("grid_format_cellid", cells, index)
}

#' grid_geometrykloop (generated binding)
#' @export
grid_geometrykloop <- function(geom, resolution, k, index = NULL) {
  .mosaic_call("grid_geometrykloop", geom, resolution, k, index)
}

#' grid_geometrykloopexplode (generated binding)
#' @export
grid_geometrykloopexplode <- function(geom, resolution, k, index = NULL) {
  .mosaic_call("grid_geometrykloopexplode", geom, resolution, k, index)
}

#' grid_geometrykring (generated binding)
#' @export
grid_geometrykring <- function(geom, resolution, k, index = NULL) {
  .mosaic_call("grid_geometrykring", geom, resolution, k, index)
}

#' grid_geometrykringexplode (generated binding)
#' @export
grid_geometrykringexplode <- function(geom, resolution, k, index = NULL) {
  .mosaic_call("grid_geometrykringexplode", geom, resolution, k, index)
}

#' grid_is_valid_cellid (generated binding)
#' @export
grid_is_valid_cellid <- function(cells, index = NULL) {
  .mosaic_call("grid_is_valid_cellid", cells, index)
}

#' grid_longlatascellid (generated binding)
#' @export
grid_longlatascellid <- function(lon, lat, resolution, index = NULL, device = NULL) {
  .mosaic_call("grid_longlatascellid", lon, lat, resolution, index, device)
}

#' grid_parse_cellid (generated binding)
#' @export
grid_parse_cellid <- function(strs, index = NULL) {
  .mosaic_call("grid_parse_cellid", strs, index)
}

#' grid_pointascellid (generated binding)
#' @export
grid_pointascellid <- function(geom, resolution, index = NULL) {
  .mosaic_call("grid_pointascellid", geom, resolution, index)
}

#' grid_polyfill (generated binding)
#' @export
grid_polyfill <- function(geom, resolution, index = NULL) {
  .mosaic_call("grid_polyfill", geom, resolution, index)
}

#' grid_resolution (generated binding)
#' @export
grid_resolution <- function(cells, index = NULL) {
  .mosaic_call("grid_resolution", cells, index)
}

#' grid_tessellate (generated binding)
#' @export
grid_tessellate <- function(geom, resolution, keep_core_geoms = TRUE, index = NULL) {
  .mosaic_call("grid_tessellate", geom, resolution, keep_core_geoms, index)
}

#' grid_tessellateaslong (generated binding)
#' @export
grid_tessellateaslong <- function(geom, resolution, keep_core_geoms = TRUE, index = NULL) {
  .mosaic_call("grid_tessellateaslong", geom, resolution, keep_core_geoms, index)
}

#' grid_tessellateexplode (generated binding)
#' @export
grid_tessellateexplode <- function(geom, resolution, keep_core_geoms = TRUE, index = NULL) {
  .mosaic_call("grid_tessellateexplode", geom, resolution, keep_core_geoms, index)
}

#' index_geometry (generated binding)
#' @export
index_geometry <- function(cells, index = NULL) {
  .mosaic_call("index_geometry", cells, index)
}

#' mosaic_explode (generated binding)
#' @export
mosaic_explode <- function(geom, resolution, keep_core_geoms = TRUE, index = NULL) {
  .mosaic_call("mosaic_explode", geom, resolution, keep_core_geoms, index)
}

#' mosaicfill (generated binding)
#' @export
mosaicfill <- function(geom, resolution, keep_core_geoms = TRUE, index = NULL) {
  .mosaic_call("mosaicfill", geom, resolution, keep_core_geoms, index)
}

#' point_index_geom (generated binding)
#' @export
point_index_geom <- function(geom, resolution, index = NULL) {
  .mosaic_call("point_index_geom", geom, resolution, index)
}

#' point_index_lonlat (generated binding)
#' @export
point_index_lonlat <- function(lon, lat, resolution, index = NULL, device = NULL) {
  .mosaic_call("point_index_lonlat", lon, lat, resolution, index, device)
}

#' polyfill (generated binding)
#' @export
polyfill <- function(geom, resolution, index = NULL) {
  .mosaic_call("polyfill", geom, resolution, index)
}

#' rst_bandmetadata (generated binding)
#' @export
rst_bandmetadata <- function(col, band) {
  .mosaic_call("rst_bandmetadata", col, band)
}

#' rst_georeference (generated binding)
#' @export
rst_georeference <- function(col) {
  .mosaic_call("rst_georeference", col)
}

#' rst_height (generated binding)
#' @export
rst_height <- function(col) {
  .mosaic_call("rst_height", col)
}

#' rst_isempty (generated binding)
#' @export
rst_isempty <- function(col) {
  .mosaic_call("rst_isempty", col)
}

#' rst_mapbands (generated binding)
#' @export
rst_mapbands <- function(col, expr, tile = NULL, index = NULL, resolution = NULL, device = NULL) {
  .mosaic_call("rst_mapbands", col, expr, tile, index, resolution, device)
}

#' rst_memsize (generated binding)
#' @export
rst_memsize <- function(col) {
  .mosaic_call("rst_memsize", col)
}

#' rst_metadata (generated binding)
#' @export
rst_metadata <- function(col) {
  .mosaic_call("rst_metadata", col)
}

#' rst_ndvi (generated binding)
#' @export
rst_ndvi <- function(col, nir_band = 2, red_band = 1, tile = NULL, device = NULL) {
  .mosaic_call("rst_ndvi", col, nir_band, red_band, tile, device)
}

#' rst_numbands (generated binding)
#' @export
rst_numbands <- function(col) {
  .mosaic_call("rst_numbands", col)
}

#' rst_pixelheight (generated binding)
#' @export
rst_pixelheight <- function(col) {
  .mosaic_call("rst_pixelheight", col)
}

#' rst_pixelwidth (generated binding)
#' @export
rst_pixelwidth <- function(col) {
  .mosaic_call("rst_pixelwidth", col)
}

#' rst_rastertogridavg (generated binding)
#' @export
rst_rastertogridavg <- function(col, resolution, index = NULL, raster_srid = NULL, device = NULL) {
  .mosaic_call("rst_rastertogridavg", col, resolution, index, raster_srid, device)
}

#' rst_rastertogridcount (generated binding)
#' @export
rst_rastertogridcount <- function(col, resolution, index = NULL, raster_srid = NULL, device = NULL) {
  .mosaic_call("rst_rastertogridcount", col, resolution, index, raster_srid, device)
}

#' rst_rastertogridmax (generated binding)
#' @export
rst_rastertogridmax <- function(col, resolution, index = NULL, raster_srid = NULL, device = NULL) {
  .mosaic_call("rst_rastertogridmax", col, resolution, index, raster_srid, device)
}

#' rst_rastertogridmedian (generated binding)
#' @export
rst_rastertogridmedian <- function(col, resolution, index = NULL, raster_srid = NULL, device = NULL) {
  .mosaic_call("rst_rastertogridmedian", col, resolution, index, raster_srid, device)
}

#' rst_rastertogridmin (generated binding)
#' @export
rst_rastertogridmin <- function(col, resolution, index = NULL, raster_srid = NULL, device = NULL) {
  .mosaic_call("rst_rastertogridmin", col, resolution, index, raster_srid, device)
}

#' rst_rastertoworldcoord (generated binding)
#' @export
rst_rastertoworldcoord <- function(col, x, y) {
  .mosaic_call("rst_rastertoworldcoord", col, x, y)
}

#' rst_rastertoworldcoordx (generated binding)
#' @export
rst_rastertoworldcoordx <- function(col, x, y) {
  .mosaic_call("rst_rastertoworldcoordx", col, x, y)
}

#' rst_rastertoworldcoordy (generated binding)
#' @export
rst_rastertoworldcoordy <- function(col, x, y) {
  .mosaic_call("rst_rastertoworldcoordy", col, x, y)
}

#' rst_retile (generated binding)
#' @export
rst_retile <- function(col, tile_width, tile_height) {
  .mosaic_call("rst_retile", col, tile_width, tile_height)
}

#' rst_rotation (generated binding)
#' @export
rst_rotation <- function(col) {
  .mosaic_call("rst_rotation", col)
}

#' rst_scalex (generated binding)
#' @export
rst_scalex <- function(col) {
  .mosaic_call("rst_scalex", col)
}

#' rst_scaley (generated binding)
#' @export
rst_scaley <- function(col) {
  .mosaic_call("rst_scaley", col)
}

#' rst_skewx (generated binding)
#' @export
rst_skewx <- function(col) {
  .mosaic_call("rst_skewx", col)
}

#' rst_skewy (generated binding)
#' @export
rst_skewy <- function(col) {
  .mosaic_call("rst_skewy", col)
}

#' rst_srid (generated binding)
#' @export
rst_srid <- function(col) {
  .mosaic_call("rst_srid", col)
}

#' rst_subdatasets (generated binding)
#' @export
rst_subdatasets <- function(col) {
  .mosaic_call("rst_subdatasets", col)
}

#' rst_summary (generated binding)
#' @export
rst_summary <- function(col) {
  .mosaic_call("rst_summary", col)
}

#' rst_upperleftx (generated binding)
#' @export
rst_upperleftx <- function(col) {
  .mosaic_call("rst_upperleftx", col)
}

#' rst_upperlefty (generated binding)
#' @export
rst_upperlefty <- function(col) {
  .mosaic_call("rst_upperlefty", col)
}

#' rst_width (generated binding)
#' @export
rst_width <- function(col) {
  .mosaic_call("rst_width", col)
}

#' rst_worldtorastercoord (generated binding)
#' @export
rst_worldtorastercoord <- function(col, x, y) {
  .mosaic_call("rst_worldtorastercoord", col, x, y)
}

#' rst_worldtorastercoordx (generated binding)
#' @export
rst_worldtorastercoordx <- function(col, x, y) {
  .mosaic_call("rst_worldtorastercoordx", col, x, y)
}

#' rst_worldtorastercoordy (generated binding)
#' @export
rst_worldtorastercoordy <- function(col, x, y) {
  .mosaic_call("rst_worldtorastercoordy", col, x, y)
}

#' st_area (generated binding)
#' @export
st_area <- function(geom, backend = NULL, device = NULL) {
  .mosaic_call("st_area", geom, backend, device)
}

#' st_asbinary (generated binding)
#' @export
st_asbinary <- function(geom) {
  .mosaic_call("st_asbinary", geom)
}

#' st_asgeojson (generated binding)
#' @export
st_asgeojson <- function(geom) {
  .mosaic_call("st_asgeojson", geom)
}

#' st_astext (generated binding)
#' @export
st_astext <- function(geom) {
  .mosaic_call("st_astext", geom)
}

#' st_aswkb (generated binding)
#' @export
st_aswkb <- function(geom) {
  .mosaic_call("st_aswkb", geom)
}

#' st_aswkt (generated binding)
#' @export
st_aswkt <- function(geom) {
  .mosaic_call("st_aswkt", geom)
}

#' st_buffer (generated binding)
#' @export
st_buffer <- function(geom, distance, quad_segs = 8) {
  .mosaic_call("st_buffer", geom, distance, quad_segs)
}

#' st_bufferloop (generated binding)
#' @export
st_bufferloop <- function(geom, inner, outer) {
  .mosaic_call("st_bufferloop", geom, inner, outer)
}

#' st_centroid (generated binding)
#' @export
st_centroid <- function(geom, backend = NULL, device = NULL) {
  .mosaic_call("st_centroid", geom, backend, device)
}

#' st_centroid2D (generated binding)
#' @export
st_centroid2D <- function(geom, backend = NULL, device = NULL) {
  .mosaic_call("st_centroid2D", geom, backend, device)
}

#' st_centroid2d (generated binding)
#' @export
st_centroid2d <- function(geom, backend = NULL, device = NULL) {
  .mosaic_call("st_centroid2d", geom, backend, device)
}

#' st_centroid3D (generated binding)
#' @export
st_centroid3D <- function(geom, backend = NULL, device = NULL) {
  .mosaic_call("st_centroid3D", geom, backend, device)
}

#' st_centroid3d (generated binding)
#' @export
st_centroid3d <- function(geom, backend = NULL, device = NULL) {
  .mosaic_call("st_centroid3d", geom, backend, device)
}

#' st_contains (generated binding)
#' @export
st_contains <- function(geom_a, geom_b, backend = NULL, device = NULL) {
  .mosaic_call("st_contains", geom_a, geom_b, backend, device)
}

#' st_convexhull (generated binding)
#' @export
st_convexhull <- function(geom) {
  .mosaic_call("st_convexhull", geom)
}

#' st_difference (generated binding)
#' @export
st_difference <- function(geom_a, geom_b, backend = NULL) {
  .mosaic_call("st_difference", geom_a, geom_b, backend)
}

#' st_distance (generated binding)
#' @export
st_distance <- function(geom_a, geom_b, backend = NULL, device = NULL) {
  .mosaic_call("st_distance", geom_a, geom_b, backend, device)
}

#' st_dump (generated binding)
#' @export
st_dump <- function(geom) {
  .mosaic_call("st_dump", geom)
}

#' st_envelope (generated binding)
#' @export
st_envelope <- function(geom) {
  .mosaic_call("st_envelope", geom)
}

#' st_geometrytype (generated binding)
#' @export
st_geometrytype <- function(geom) {
  .mosaic_call("st_geometrytype", geom)
}

#' st_geomfromgeojson (generated binding)
#' @export
st_geomfromgeojson <- function(docs) {
  .mosaic_call("st_geomfromgeojson", docs)
}

#' st_geomfromwkb (generated binding)
#' @export
st_geomfromwkb <- function(blobs, srid = 4326) {
  .mosaic_call("st_geomfromwkb", blobs, srid)
}

#' st_geomfromwkt (generated binding)
#' @export
st_geomfromwkt <- function(wkts, srid = 4326) {
  .mosaic_call("st_geomfromwkt", wkts, srid)
}

#' st_hasvalidcoordinates (generated binding)
#' @export
st_hasvalidcoordinates <- function(geom, crs_code, which = "bounds") {
  .mosaic_call("st_hasvalidcoordinates", geom, crs_code, which)
}

#' st_intersection (generated binding)
#' @export
st_intersection <- function(geom_a, geom_b, backend = NULL) {
  .mosaic_call("st_intersection", geom_a, geom_b, backend)
}

#' st_intersection_aggregate (generated binding)
#' @export
st_intersection_aggregate <- function(index, cells, a_is_core, b_is_core, a_chips, b_chips, groups = NULL) {
  .mosaic_call("st_intersection_aggregate", index, cells, a_is_core, b_is_core, a_chips, b_chips, groups)
}

#' st_intersection_area (generated binding)
#' @export
st_intersection_area <- function(geom_a, geom_b, index_system, resolution, ...) {
  .mosaic_call("st_intersection_area", geom_a, geom_b, index_system, resolution, ...)
}

#' st_intersects (generated binding)
#' @export
st_intersects <- function(geom_a, geom_b, backend = NULL, device = NULL) {
  .mosaic_call("st_intersects", geom_a, geom_b, backend, device)
}

#' st_intersects_aggregate (generated binding)
#' @export
st_intersects_aggregate <- function(cells, a_is_core, b_is_core, a_chips, b_chips, groups = NULL) {
  .mosaic_call("st_intersects_aggregate", cells, a_is_core, b_is_core, a_chips, b_chips, groups)
}

#' st_isvalid (generated binding)
#' @export
st_isvalid <- function(geom) {
  .mosaic_call("st_isvalid", geom)
}

#' st_length (generated binding)
#' @export
st_length <- function(geom, backend = NULL, device = NULL) {
  .mosaic_call("st_length", geom, backend, device)
}

#' st_makeline (generated binding)
#' @export
st_makeline <- function(points_per_row, srid = 4326) {
  .mosaic_call("st_makeline", points_per_row, srid)
}

#' st_makepolygon (generated binding)
#' @export
st_makepolygon <- function(boundary, holes = NULL) {
  .mosaic_call("st_makepolygon", boundary, holes)
}

#' st_numpoints (generated binding)
#' @export
st_numpoints <- function(geom) {
  .mosaic_call("st_numpoints", geom)
}

#' st_overlap_fraction (generated binding)
#' @export
st_overlap_fraction <- function(geom_a, geom_b, index_system, resolution, ...) {
  .mosaic_call("st_overlap_fraction", geom_a, geom_b, index_system, resolution, ...)
}

#' st_perimeter (generated binding)
#' @export
st_perimeter <- function(geom, backend = NULL, device = NULL) {
  .mosaic_call("st_perimeter", geom, backend, device)
}

#' st_point (generated binding)
#' @export
st_point <- function(x, y, srid = 4326) {
  .mosaic_call("st_point", x, y, srid)
}

#' st_polygon (generated binding)
#' @export
st_polygon <- function(boundary, holes = NULL) {
  .mosaic_call("st_polygon", boundary, holes)
}

#' st_rotate (generated binding)
#' @export
st_rotate <- function(geom, theta) {
  .mosaic_call("st_rotate", geom, theta)
}

#' st_scale (generated binding)
#' @export
st_scale <- function(geom, sx, sy) {
  .mosaic_call("st_scale", geom, sx, sy)
}

#' st_setsrid (generated binding)
#' @export
st_setsrid <- function(geom, srid) {
  .mosaic_call("st_setsrid", geom, srid)
}

#' st_simplify (generated binding)
#' @export
st_simplify <- function(geom, tolerance) {
  .mosaic_call("st_simplify", geom, tolerance)
}

#' st_srid (generated binding)
#' @export
st_srid <- function(geom) {
  .mosaic_call("st_srid", geom)
}

#' st_symdifference (generated binding)
#' @export
st_symdifference <- function(geom_a, geom_b, backend = NULL) {
  .mosaic_call("st_symdifference", geom_a, geom_b, backend)
}

#' st_transform (generated binding)
#' @export
st_transform <- function(geom, to_srid) {
  .mosaic_call("st_transform", geom, to_srid)
}

#' st_translate (generated binding)
#' @export
st_translate <- function(geom, dx, dy) {
  .mosaic_call("st_translate", geom, dx, dy)
}

#' st_unaryunion (generated binding)
#' @export
st_unaryunion <- function(geom) {
  .mosaic_call("st_unaryunion", geom)
}

#' st_union (generated binding)
#' @export
st_union <- function(geom_a, geom_b, backend = NULL) {
  .mosaic_call("st_union", geom_a, geom_b, backend)
}

#' st_union_agg (generated binding)
#' @export
st_union_agg <- function(geom, groups = NULL) {
  .mosaic_call("st_union_agg", geom, groups)
}

#' st_updatesrid (generated binding)
#' @export
st_updatesrid <- function(geom, from_srid, to_srid) {
  .mosaic_call("st_updatesrid", geom, from_srid, to_srid)
}

#' st_x (generated binding)
#' @export
st_x <- function(geom) {
  .mosaic_call("st_x", geom)
}

#' st_xmax (generated binding)
#' @export
st_xmax <- function(geom, backend = NULL, device = NULL) {
  .mosaic_call("st_xmax", geom, backend, device)
}

#' st_xmin (generated binding)
#' @export
st_xmin <- function(geom, backend = NULL, device = NULL) {
  .mosaic_call("st_xmin", geom, backend, device)
}

#' st_y (generated binding)
#' @export
st_y <- function(geom) {
  .mosaic_call("st_y", geom)
}

#' st_ymax (generated binding)
#' @export
st_ymax <- function(geom, backend = NULL, device = NULL) {
  .mosaic_call("st_ymax", geom, backend, device)
}

#' st_ymin (generated binding)
#' @export
st_ymin <- function(geom, backend = NULL, device = NULL) {
  .mosaic_call("st_ymin", geom, backend, device)
}

#' st_zmax (generated binding)
#' @export
st_zmax <- function(geom) {
  .mosaic_call("st_zmax", geom)
}

#' st_zmin (generated binding)
#' @export
st_zmin <- function(geom) {
  .mosaic_call("st_zmin", geom)
}

#' try_sql (generated binding)
#' @export
try_sql <- function(fn, ...) {
  .mosaic_call("try_sql", fn, ...)
}

#' try_sql_columnar (generated binding)
#' @export
try_sql_columnar <- function(fn, ...) {
  .mosaic_call("try_sql_columnar", fn, ...)
}
